"""Multi-stream serving: N independent audio streams on one chip.

The reference architecture is one stream per process
(src/alsa/alsa_streamer_main.cpp) — which squanders a chip that runs 16x
stereo at thousands of times realtime. totton-serve multiplexes many
independent client streams onto ONE batched engine dispatch:

- **Slots as batch rows.** The server has a fixed number of stream slots
  (--max-streams); each slot owns `channels` rows of one jitted step over
  `[slots * channels, block_in]`. Shapes are static, so clients joining
  and leaving never recompile anything.
- **Host-managed tails.** Overlap-save state is just the last halo_in
  INPUT samples per row — which the host already holds (it fed them). The
  dispatcher passes each slot's tail explicitly and updates it only for
  slots that consumed real input this step; idle slots compute garbage
  rows that are simply discarded. No per-stream engine state lives on
  the device, so a disconnecting client can't perturb any other stream.
- **Natural batching.** One stream's single-block step is 2 frames; 64
  concurrent streams make the same step 128 frames, so the device's
  fixed per-step cost is shared by every active stream.
- **Per-stream backpressure.** A slot is dispatch-ready only when its
  input ring holds a whole block AND its output backlog is under the
  block-granular soft limit, so a slow client throttles itself via TCP
  flow control and never BLOCKS the other streams. Adaptive batching
  (below) does add bounded step-width coupling: while one client bursts,
  every step is up to max_blocks_per_step wide, so an interactive
  stream's block waits one wider step (~15 ms at the production 16x
  geometry) — small against the >= 72 ms a 44.1 kHz client inherently
  spends accumulating each 3192-frame block.
- **Adaptive step depth.** The per-step block count follows the deepest
  ready backlog (power-of-two, floor-quantized, capped): bursty
  file-upsample clients batch up to 16 blocks per dispatch while
  trickling clients' rows are zero-padded (outputs trimmed at their
  valid frames, tails advanced by real frames only).

Wire protocol: one duplex TCP/unix connection per stream. The client
sends the 12-byte totton header (io/sockets.py) + interleaved PCM at the
serve rate; the server answers with a header at rate*ratio and streams
the upsampled PCM back on the same connection. EOF (half-close) flushes
the final partial block zero-padded/trimmed, reference file-mode
semantics (alsa_streamer_main.cpp:301-303).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import socket
import threading
import time

import numpy as np

from totton_tpu.filters.sidecar import LoadedFilter
from totton_tpu.io.pcm import (
    PcmFormat,
    deinterleave,
    float_to_pcm,
    interleave,
    pcm_to_float,
)
from totton_tpu.io.sockets import (
    FLAG_EQ_BLOCK,
    HEADER_BYTES,
    SocketSpec,
    _listen,
    _recv_exact,
    _tune,
    header_flags,
    pack_header,
    unpack_header,
)
from totton_tpu.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    make_block_step,
)

log = logging.getLogger("totton.serve")

#: cap on a client's per-stream EQ block (an APO profile is ~100 bytes
#: per band; this admits hundreds of bands while bounding a hostile
#: length field)
MAX_EQ_BLOCK_BYTES = 65536


def process_rss_mb() -> float | None:
    """This process's resident set size in MB (None where /proc is
    unavailable). Operator signal for bounded-memory serving: a device
    runtime that leaks host memory per dispatch below this framework
    grows a long-lived server without bound, so such servers watch RSS
    and recycle (totton-serve --recycle-rss-mb)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def _profile_to_sos(profile, sample_rate: float):
    """APO profile -> (scipy sos array or None, linear preamp gain).

    Per-stream EQ is applied TIME-DOMAIN at the INPUT rate (scipy sosfilt
    with carried per-slot state): every stream gets its own EQ without
    a filter spectrum per stream on the device (one spectrum serves every
    row of the batched step). The biquads are the same RBJ
    designs the spectral bake-in uses; designing them at the input rate
    instead of the output rate shifts responses only through bilinear
    warping near the input Nyquist — EQ bands live well below it.
    """
    from totton_tpu.eq.biquad import biquad_coeffs

    rows = []
    for band in profile.bands:
        c = biquad_coeffs(band, sample_rate)
        if not c.is_identity:
            rows.append([c.b0, c.b1, c.b2, 1.0, c.a1, c.a2])
    preamp = 10.0 ** (profile.preamp_db / 20.0)
    if not rows:
        return None, preamp
    return np.asarray(rows, dtype=np.float64), preamp


@dataclasses.dataclass
class SlotStats:
    frames_in: int = 0
    frames_out: int = 0
    connected_at: float = 0.0
    #: episodes where the reader stopped recv'ing because the input
    #: backlog hit its cap (TCP flow control then throttles the sender)
    input_throttles: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class StreamSlot:
    """One client stream: connection + rings + host-side tail."""

    def __init__(self, index: int, channels: int, halo_in: int,
                 block_in: int, block_out: int,
                 out_queue_blocks: int = 8,
                 max_input_blocks: int = 32) -> None:
        self.index = index
        self.channels = channels
        self.block_in = block_in
        self.block_out = block_out
        self.tail = np.zeros((channels, halo_in), np.float32)
        self.buf = np.zeros((channels, 0), np.float32)
        self.buf_lock = threading.Lock()
        # Input-side bound (the output side was always block-capped): the
        # reader stops recv'ing once this many whole blocks are buffered,
        # so a client that floods input while never reading output is
        # throttled by TCP flow control instead of ballooning host memory
        # until the process OOMs under every other stream (the reference
        # analog is its fixed-capacity SPSC ring,
        # include/io/audio_ring_buffer.h:22-30).
        self.max_input_samples = max_input_blocks * block_in
        #: set whenever the dispatcher consumes input (wakes a throttled
        #: reader); cleared by the reader before it re-checks fullness
        self.space = threading.Event()
        #: monotonic timestamps, one per COMPLETED input block, consumed
        #: FIFO by take_blocks -> latency = output-queued minus these
        self.block_ts: list[float] = []
        #: per-stream latency reservoir (ms), input-ready -> output-queued
        self.lat_ms: "list[float]" = []
        # Hard capacity = soft gate + headroom for steps already in
        # flight when the gate was passed, so a healthy stream's drain
        # can never block the shared dispatcher (ready() gates on the
        # SOFT limit; the hard limit is only reachable by a stalled
        # client, which gets cut).
        self.out_soft_limit = out_queue_blocks
        self.out: queue.Queue = queue.Queue(maxsize=out_queue_blocks * 2)
        # Output buffering accounted in BLOCKS, not queue items: adaptive
        # batching makes one item worth up to max_blocks_per_step blocks,
        # so the backpressure gate counts what actually buffers.
        self.out_blocks = 0
        self.out_lock = threading.Lock()
        self.sock: socket.socket | None = None
        self.fmt: PcmFormat | None = None
        # Per-slot crossfade state for live spectrum swaps (dispatcher
        # thread only): each stream fades old -> new over its OWN next
        # swap_fade_frames output samples, however its dispatches land.
        self.fade_from = None     # pre-swap spectrum (device array ref)
        self.fade_pos = 0         # output samples of the fade already mixed
        # Per-stream EQ (scipy sos + carried filter state + preamp gain).
        self.eq_sos: np.ndarray | None = None
        self.eq_zi: np.ndarray | None = None
        self.eq_preamp: float = 1.0
        self.eof = False          # client half-closed; flush then finish
        self.flushed = False      # final partial block dispatched
        self.finished = False     # writer told to stop (None sentinel sent)
        self.detached = True      # connection torn down (dispatcher frees)
        self.generation = 0       # bumped per attachment (stale-thread guard)
        self.pending_steps = 0    # dispatched steps not yet drained
        self.closing = threading.Event()
        self.stats = SlotStats(connected_at=time.monotonic())
        self.reader: threading.Thread | None = None
        self.writer: threading.Thread | None = None

    def push_input(self, frames: np.ndarray) -> None:
        now = time.monotonic()
        with self.buf_lock:
            before = self.buf.shape[1] // self.block_in
            self.buf = np.concatenate([self.buf, frames], axis=1)
            after = self.buf.shape[1] // self.block_in
            # One input-ready timestamp per block COMPLETED by this push
            # (the block's last sample just arrived).
            self.block_ts.extend([now] * (after - before))
        self.stats.frames_in += frames.shape[1]

    def note_eof_partial(self) -> None:
        """EOF with a trailing partial block: the partial became
        dispatchable now — stamp its input-ready time."""
        with self.buf_lock:
            if self.buf.shape[1] % self.block_in:
                self.block_ts.append(time.monotonic())

    def input_full(self) -> bool:
        with self.buf_lock:
            return self.buf.shape[1] >= self.max_input_samples

    def blocks_available(self) -> int:
        """Whole blocks ready (EOF counts a pending partial as one)."""
        with self.buf_lock:
            n = self.buf.shape[1] // self.block_in
            if n == 0 and self.eof and not self.flushed \
                    and self.buf.shape[1] > 0:
                return 1
            return n

    def take_blocks(self, k: int) -> tuple[np.ndarray, int, list] | None:
        """Up to k whole blocks (the final EOF partial zero-padded),
        returned as [C, k*block_in] with the unused tail zero-padded.
        Returns (frames, valid_frames, block_ready_timestamps) or None
        when nothing is ready."""
        with self.buf_lock:
            n = self.buf.shape[1]
            take = min(n - n % self.block_in, k * self.block_in)
            if take < n and self.eof and not self.flushed \
                    and take + self.block_in <= k * self.block_in:
                # EOF: fold the trailing partial into this dispatch.
                self.flushed = True
                take = min(n, k * self.block_in)
            if take == 0:
                return None
            frames = self.buf[:, :take]
            self.buf = self.buf[:, take:]
            nb = -(-take // self.block_in)
            ts, self.block_ts = self.block_ts[:nb], self.block_ts[nb:]
        self.space.set()  # wake a reader throttled on the input cap
        valid = take
        pad = k * self.block_in - take
        if pad:
            frames = np.pad(frames, [(0, 0), (0, pad)])
        return np.ascontiguousarray(frames), valid, ts

    def ready(self) -> bool:
        if self.sock is None or self.closing.is_set():
            return False
        with self.out_lock:
            backlog = self.out_blocks
        if backlog >= self.out_soft_limit:
            return False  # slow client: let TCP backpressure throttle it
        with self.buf_lock:
            if self.buf.shape[1] >= self.block_in:
                return True
            return self.eof and not self.flushed and self.buf.shape[1] > 0


class ServeStats:
    """Aggregate serving counters (periodically written to stats_path)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.accepted = 0
        self.rejected = 0
        self.finished = 0
        self.steps = 0
        self.frames_out = 0
        self.spectrum_swaps = 0   # live RELOAD/EQ/phase swaps applied
        self.soft_resets = 0
        self.drain_wall_s = 0.0   # summed device-wait time in _drain_one
        #: dispatch count per "slots x blocks" shape (adaptive width/depth
        #: observability: shows what the chip actually ran)
        self.steps_by_shape: dict[str, int] = {}
        self.start = time.monotonic()

    def to_json(self, active: int, per_stream: list[dict]) -> dict:
        rss = process_rss_mb()
        with self.lock:
            return {
                "uptime_ms": int((time.monotonic() - self.start) * 1000),
                "rss_mb": round(rss, 1) if rss is not None else None,
                "streams": {"active": active, "accepted": self.accepted,
                            "rejected": self.rejected,
                            "finished": self.finished},
                "steps": self.steps,
                "steps_by_shape": dict(self.steps_by_shape),
                "spectrum_swaps": self.spectrum_swaps,
                "soft_resets": self.soft_resets,
                "frames_out": self.frames_out,
                "avg_step_drain_ms": round(
                    self.drain_wall_s / self.steps * 1e3, 3)
                    if self.steps else None,
                "per_stream": per_stream,
            }


class StreamServer:
    """Accepts duplex PCM connections and serves them from one batched
    engine step (module docstring for the design)."""

    def __init__(
        self,
        filt: LoadedFilter,
        endpoint: str,
        sample_rate: int,
        max_streams: int = 64,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
        stats_path: str | None = None,
        header_timeout_s: float = 10.0,
        max_blocks_per_step: int = 16,
        max_input_backlog_blocks: int = 32,
        swap_fade_frames: int = 0,
        mesh=None,
        device_pcm: bool = False,
    ) -> None:
        self.config = OverlapSaveConfig.from_sidecar(filt.sidecar)
        self._filter = filt
        # Device-PCM serving: quantize the batched step output to int16
        # ON the device, halving every stream's share of the
        # device->host drain (avg_step_drain_ms in stats). s16-only: the
        # acceptor rejects other wire formats. Fade steps fall back to
        # the host float path and quantize with the bit-exact host twin
        # (engine.StreamingUpsampler's device_pcm contract).
        self.device_pcm = bool(device_pcm)
        self.sample_rate = sample_rate
        self.max_streams = max_streams
        self.channels = channels
        self.spec = SocketSpec(endpoint)
        if not self.spec.listen:
            raise ValueError(
                f"serve endpoint must be a listen spec, got {endpoint!r}")
        self._spectrum = filter_spectrum(filt.taps, self.config.fft_size,
                                         eq_response)
        self._step = make_block_step(self.config)
        self._rows = max_streams * channels
        # Adaptive row width: each step dispatches the smallest warmed
        # power-of-two slot width covering the READY slots (served slots
        # are compacted into leading rows), so a lightly-loaded server
        # pays the 8-slot step cost instead of the widest one. Width
        # floor 8: below it a step costs its fixed per-dispatch overhead,
        # so narrower shapes buy nothing.
        from totton_tpu.utils.intmath import pow2_ceil

        top = pow2_ceil(max_streams)
        self._slot_widths = sorted(
            {w for w in (8, 16, 32, 64, 128, 256, 512, 1024)
             if w < top and w >= min(8, top)} | {top})
        # Multi-chip serving: slot rows sharded over the mesh. Serving is
        # embarrassingly row-parallel — tails are HOST-managed, so the
        # sharded step needs no ppermute/collectives at all; N chips
        # serve ~N x the slots of one (SURVEY.md §2.3 charter; the
        # reference is one stream per process on one GPU). The step
        # program is unchanged: inputs are device_put with a row
        # sharding and XLA partitions the batch axis.
        self.mesh = mesh
        self._sharding = None
        if mesh is not None and int(mesh.devices.size) > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = int(mesh.devices.size)
            self._sharding = NamedSharding(
                mesh, P(tuple(mesh.axis_names)))
            widths = [w for w in self._slot_widths
                      if (w * channels) % n_dev == 0]
            if not widths:
                raise ValueError(
                    f"no serve step width in {self._slot_widths} shards "
                    f"{channels}-channel slot rows evenly over {n_dev} "
                    "devices; raise --max-streams or shrink the mesh")
            self._slot_widths = widths
        if max_input_backlog_blocks < max_blocks_per_step:
            raise ValueError(
                "max_input_backlog_blocks must be >= max_blocks_per_step "
                f"({max_input_backlog_blocks} < {max_blocks_per_step})")
        self.slots = [
            StreamSlot(i, channels, self.config.halo_in,
                       self.config.block_in, self.config.block_size,
                       max_input_blocks=max_input_backlog_blocks)
            for i in range(max_streams)
        ]
        self._free = list(range(max_streams))
        self._slot_lock = threading.Lock()
        self.stats = ServeStats()
        self._stats_path = stats_path
        if max_blocks_per_step < 1 or (
                max_blocks_per_step & (max_blocks_per_step - 1)):
            raise ValueError("max_blocks_per_step must be a power of two, "
                             f"got {max_blocks_per_step}")
        #: cap on the adaptive per-step block depth (see _gather)
        self.max_blocks_per_step = max_blocks_per_step
        self._header_timeout_s = header_timeout_s
        # Live control (set_eq / load_filter / soft_reset): control
        # threads QUEUE the change here; the dispatcher applies it at its
        # next step boundary, arming each active stream's per-slot
        # crossfade. All spectrum mutation thus happens on the dispatcher
        # thread — no step can straddle a half-applied swap.
        if swap_fade_frames < 0:
            raise ValueError(
                f"swap_fade_frames must be >= 0: {swap_fade_frames}")
        self._swap_fade_frames = swap_fade_frames
        self._swap_lock = threading.Lock()
        self._pending_spectrum = None
        self._pending_reset = False
        self._stop = threading.Event()
        #: set when the dispatcher stopped the server on persistent
        #: failure (the CLI exits nonzero on it)
        self.failed = False
        self._srv: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        #: wake the dispatcher when any slot becomes ready
        self._kick = threading.Event()

    # -- connection handling ----------------------------------------------

    def _acceptor(self) -> None:
        while not self._stop.is_set():
            srv = self._srv  # drain() nulls it to stop accepting
            if srv is None:
                return
            try:
                srv.settimeout(0.5)
                sock, _addr = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                # Bounded header wait: a connected-but-silent client must
                # not block the accept loop (trivial DoS otherwise).
                sock.settimeout(self._header_timeout_s)
                raw = _recv_exact(sock, HEADER_BYTES)
                fmt, ch, rate = unpack_header(raw)
                eq = self._read_eq_block(sock, header_flags(raw))
                _tune(sock, self.spec)  # blocking mode for the stream
            except (OSError, ValueError, ConnectionError) as e:
                log.warning("serve: bad client header: %s", e)
                sock.close()
                with self.stats.lock:
                    self.stats.rejected += 1
                continue
            if ch != self.channels or (rate and rate != self.sample_rate):
                log.warning(
                    "serve: rejecting stream (ch=%d rate=%d; serving "
                    "ch=%d rate=%d)", ch, rate, self.channels,
                    self.sample_rate)
                with self.stats.lock:
                    self.stats.rejected += 1
                sock.close()
                continue
            if self.device_pcm and fmt is not PcmFormat.S16_LE:
                log.warning("serve: rejecting stream (device-PCM serving "
                            "is s16-only, client sent %s)", fmt)
                with self.stats.lock:
                    self.stats.rejected += 1
                sock.close()
                continue
            with self._slot_lock:
                idx = self._free.pop() if self._free else None
                if idx is not None:
                    # Claim inside the lock: _release_detached_slots must
                    # not re-free an index between pop and attach.
                    self.slots[idx].detached = False
            if idx is None:
                log.warning("serve: all %d slots busy, rejecting",
                            self.max_streams)
                with self.stats.lock:
                    self.stats.rejected += 1
                sock.close()
                continue
            slot = self.slots[idx]
            self._attach(slot, sock, fmt, eq)

    def _read_eq_block(self, sock: socket.socket, flags: int):
        """Optional per-stream EQ: FLAG_EQ_BLOCK announces a u32 LE
        length + UTF-8 Equalizer-APO profile right after the header.
        Returns (sos, preamp) or None. Raises (rejecting the stream) on
        a hostile length or a non-UTF-8 block; PARSING is lenient like
        the reference's APO parser — lines its grammar rejects are
        skipped, so a junk-only profile degrades to identity EQ rather
        than a rejection (tests/test_serve.py
        test_unparseable_lines_tolerated codifies this)."""
        if not flags & FLAG_EQ_BLOCK:
            return None
        import struct

        (length,) = struct.unpack("<I", _recv_exact(sock, 4))
        if length > MAX_EQ_BLOCK_BYTES:
            raise ValueError(f"EQ block too large: {length} bytes")
        from totton_tpu.eq.apo import parse_eq_string

        text = _recv_exact(sock, length).decode("utf-8")
        profile = parse_eq_string(text)
        return _profile_to_sos(profile, float(self.sample_rate))

    def _attach(self, slot: StreamSlot, sock: socket.socket,
                fmt: PcmFormat | None, eq=None) -> None:
        slot.tail[:] = 0.0
        slot.buf = np.zeros((self.channels, 0), np.float32)
        slot.block_ts = []
        slot.lat_ms = []
        slot.space.set()
        while not slot.out.empty():
            slot.out.get_nowait()
        with slot.out_lock:
            slot.out_blocks = 0
        slot.eof = False
        slot.flushed = False
        slot.finished = False
        slot.fade_from = None
        slot.fade_pos = 0
        # detached was already cleared under the acceptor's claim lock.
        slot.generation += 1
        slot.pending_steps = 0
        slot.closing.clear()
        slot.stats = SlotStats(connected_at=time.monotonic())
        slot.fmt = fmt
        slot.eq_sos, slot.eq_preamp = eq if eq is not None else (None, 1.0)
        slot.eq_zi = (np.zeros((slot.eq_sos.shape[0], self.channels, 2))
                      if slot.eq_sos is not None else None)
        # Answer with the output header on the same connection — BEFORE
        # publishing the socket on the slot: a client that already reset
        # must not kill the acceptor thread or leak the slot.
        try:
            sock.sendall(pack_header(fmt, self.channels,
                                     self.sample_rate * self.config.ratio))
        except OSError as e:
            log.warning("serve: client vanished before reply header: %s", e)
            sock.close()
            # Detach + free ATOMICALLY under the slot lock (with the same
            # not-in-free guard _release_detached_slots uses): setting
            # detached before an unguarded append would let the dispatcher
            # ALSO append the index in the window between the two, and a
            # duplicate free-list entry hands one slot to two clients.
            with self._slot_lock:
                if slot.index not in self._free:
                    self._free.append(slot.index)
                slot.detached = True
            return
        slot.sock = sock
        with self.stats.lock:
            self.stats.accepted += 1
        # Threads get THEIR socket and generation explicitly: a stale
        # reader that outlived its join timeout (blocked in recv on a
        # vanished peer) can then never read from, or EOF, the slot's
        # NEXT stream.
        slot.reader = threading.Thread(
            target=self._reader, args=(slot, sock, slot.generation),
            daemon=True, name=f"totton-serve-rd{slot.index}")
        slot.writer = threading.Thread(
            target=self._writer, args=(slot, sock), daemon=True,
            name=f"totton-serve-wr{slot.index}")
        slot.reader.start()
        slot.writer.start()
        log.info("serve: stream attached to slot %d", slot.index)

    def _reader(self, slot: StreamSlot, sock: socket.socket,
                gen: int) -> None:
        frame_bytes = self.channels * (4 if slot.fmt is None
                                       else slot.fmt.bytes)
        pending = b""
        try:
            while (not self._stop.is_set() and not slot.closing.is_set()
                   and slot.generation == gen):
                # Input-side bound: while the backlog is at its cap, stop
                # recv'ing — the kernel socket buffer fills and TCP flow
                # control throttles the sender. Bounded host memory per
                # stream no matter how hostile the client.
                throttled = False
                while slot.input_full():
                    if (self._stop.is_set() or slot.closing.is_set()
                            or slot.generation != gen):
                        return
                    if not throttled:
                        throttled = True
                        slot.stats.input_throttles += 1
                    slot.space.clear()
                    # Re-check after clear: take_blocks may have consumed
                    # (and set) between the check and the clear.
                    if not slot.input_full():
                        break
                    slot.space.wait(timeout=0.5)
                try:
                    chunk = sock.recv(65536)
                except OSError:
                    chunk = b""
                if not chunk:
                    break
                pending += chunk
                usable = len(pending) - len(pending) % frame_bytes
                if not usable:
                    continue
                raw, pending = pending[:usable], pending[usable:]
                if slot.fmt is None:
                    flat = np.frombuffer(raw, "<f4").astype(np.float32)
                else:
                    flat = pcm_to_float(raw, slot.fmt)
                frames = deinterleave(flat, self.channels)
                if slot.eq_sos is not None:
                    # Per-stream EQ: stateful sosfilt at the input rate
                    # (reader thread = per-slot, so the carried state
                    # needs no lock).
                    from scipy.signal import sosfilt

                    frames, slot.eq_zi = sosfilt(
                        slot.eq_sos, frames, axis=1, zi=slot.eq_zi)
                    frames = frames.astype(np.float32)
                if slot.eq_preamp != 1.0:
                    frames = frames * np.float32(slot.eq_preamp)
                if slot.generation != gen:
                    break
                slot.push_input(frames)
                self._kick.set()
        finally:
            if slot.generation == gen:
                slot.note_eof_partial()
                slot.eof = True
                self._kick.set()

    def _writer(self, slot: StreamSlot, sock: socket.socket) -> None:
        try:
            while True:
                item = slot.out.get()
                if item is None:
                    break
                flat = interleave(item)
                if flat.dtype == np.int16:
                    # Device-PCM serving: samples are already final s16
                    # values (bit-exact with float_to_pcm by contract).
                    raw = flat.astype("<i2", copy=False).tobytes()
                elif slot.fmt is None:
                    raw = flat.astype("<f4", copy=False).tobytes()
                else:
                    raw = float_to_pcm(flat, slot.fmt)
                try:
                    sock.sendall(raw)  # TCP backpressure per stream
                except OSError:
                    slot.closing.set()
                    break
                with slot.out_lock:
                    slot.out_blocks = max(
                        0, slot.out_blocks
                        - -(-item.shape[1] // slot.block_out))
                slot.stats.frames_out += item.shape[1]
                self._kick.set()
        finally:
            self._detach(slot)

    def _detach(self, slot: StreamSlot) -> None:
        """Tear down a stream's connection (writer thread). The SLOT is
        NOT freed here: steps referencing it may still be in flight; the
        dispatcher releases it once pending_steps drains to zero
        (_release_detached_slots) — otherwise a reattached client could
        receive the previous stream's audio."""
        sock, slot.sock = slot.sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
            # The reader exits once the socket is closed; wait for it so a
            # stale reader can never push into the slot's NEXT stream.
            if (slot.reader is not None
                    and slot.reader is not threading.current_thread()):
                slot.reader.join(timeout=10)
            with self.stats.lock:
                self.stats.finished += 1
            slot.detached = True
            self._kick.set()

    def _release_detached_slots(self) -> None:
        """Free torn-down slots whose in-flight steps have all drained
        (dispatcher thread only)."""
        for slot in self.slots:
            if slot.detached and slot.pending_steps == 0:
                with self._slot_lock:
                    # Re-check under the lock: the acceptor clears
                    # detached inside its pop critical section, so a
                    # just-claimed slot can never be re-freed here.
                    if slot.detached and slot.index not in self._free:
                        self._free.append(slot.index)
                        log.info("serve: slot %d released", slot.index)

    def _cut(self, slot: StreamSlot, why: str) -> None:
        """Cut a stalled client loose: closing + socket close unblocks its
        writer (sendall raises), whose finally runs _detach."""
        log.warning("serve: cutting slot %d (%s)", slot.index, why)
        slot.closing.set()
        sock = slot.sock  # _detach (writer thread) may null it concurrently
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- live control ------------------------------------------------------
    #
    # The reference's entire control surface (RELOAD / PHASE_TYPE_SET /
    # SOFT_RESET, src/zmq/zmq_server_main.cpp:150-221) reaches the
    # single-stream engine live; these give the SERVING plane the same
    # capability: the shared spectrum swaps under 64 live listeners with
    # a per-slot crossfade — no server restart, no click, no dropped
    # sample (the reference's RELOAD restarts the container).

    @property
    def filter(self) -> LoadedFilter:
        return self._filter

    def set_eq(self, eq_response: np.ndarray | None) -> None:
        """Hot-swap the EQ baked into the served spectrum (all streams).
        Applied by the dispatcher at its next step boundary; each active
        stream crossfades old -> new over swap_fade_frames of its own
        output."""
        spectrum = filter_spectrum(self._filter.taps, self.config.fft_size,
                                   eq_response)
        with self._swap_lock:
            self._pending_spectrum = spectrum
        self._kick.set()

    def load_filter(self, filt: LoadedFilter,
                    eq_response: np.ndarray | None = None) -> None:
        """Swap the served filter live (phase flip / RELOAD). The serve
        batch's shapes are static, so the new filter must keep the same
        overlap-save geometry — true for the bundled min/linear pairs."""
        cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
        if cfg != self.config:
            raise ValueError(
                "serve filter swap requires identical overlap-save "
                f"geometry (have {self.config}, new {cfg})")
        spectrum = filter_spectrum(filt.taps, cfg.fft_size, eq_response)
        with self._swap_lock:
            self._filter = filt
            self._pending_spectrum = spectrum
        self._kick.set()

    def soft_reset(self) -> None:
        """Zero every active stream's carried history (reference
        Reset(), vulkan_streaming_upsampler.cpp:598-600, per slot)."""
        with self._swap_lock:
            self._pending_reset = True
        self._kick.set()

    @property
    def stopped(self) -> bool:
        """True once the server has been asked to stop (or has failed)."""
        return self._stop.is_set()

    def request_stop(self) -> None:
        """Unblock wait() and stop serving (SHUTDOWN path)."""
        self._stop.set()
        self._kick.set()

    def _apply_pending_control(self) -> None:
        """Apply queued control changes at a step boundary (dispatcher
        thread only)."""
        with self._swap_lock:
            spectrum, self._pending_spectrum = self._pending_spectrum, None
            reset, self._pending_reset = self._pending_reset, False
        if reset:
            for slot in self.slots:
                slot.tail[:] = 0.0
                slot.fade_from = None
                slot.fade_pos = 0
            with self.stats.lock:
                self.stats.soft_resets += 1
            log.info("serve: soft reset (all stream histories zeroed)")
        if spectrum is not None:
            old = self._spectrum
            self._spectrum = spectrum
            if self._swap_fade_frames:
                for slot in self.slots:
                    # Arm the fade for every live stream; a stream already
                    # mid-fade keeps its ORIGINAL pre-swap spectrum (fade
                    # from what was last heard — engine._note_swap
                    # convention). Streams attaching later start clean on
                    # the new spectrum.
                    if slot.sock is not None and slot.fade_from is None:
                        slot.fade_from = old
                        slot.fade_pos = 0
            with self.stats.lock:
                self.stats.spectrum_swaps += 1
            log.info("serve: spectrum swapped live (fade %d frames)",
                     self._swap_fade_frames)

    # -- dispatcher --------------------------------------------------------

    def _gather(self) -> tuple[np.ndarray, np.ndarray, list[tuple]] | None:
        """Build one batched step from every ready slot.

        The per-step block count k adapts to the deepest ready backlog
        (power-of-two floor, capped at max_blocks_per_step): a bursty
        client — a file upsample pushed through the serving plane — gets
        up to k blocks per step instead of one, while other clients cost
        zero-padded row tails (their outputs beyond valid_frames are
        discarded and their tails advance by REAL frames only; they do
        share the wider step's bounded latency — module docstring). The
        shape universe stays the warmed {1, 2, 4, ..., cap} set.

        Served slots are COMPACTED into the leading rows and the row
        width adapts to the ready count (smallest warmed power-of-two
        slot width >= ready slots): one active stream on a 64-slot server
        dispatches an 8-slot step, not a 64-slot one.

        Returns (x [rows, k*block_in], tails [rows, halo], served) with
        served = [(slot, row0, valid_frames)], or None when idle."""
        ready = [(slot, slot.blocks_available())
                 for slot in self.slots if slot.ready()]
        ready = [(s, a) for s, a in ready if a > 0]
        if not ready:
            return None
        deepest = max(a for _, a in ready)
        # Round DOWN (stream.py _quantize_nblocks convention): a backlog
        # of 9 dispatches 8 then 1 from the same warmed shape set instead
        # of a 16-wide step that is 44% zero-pad filler.
        from totton_tpu.utils.intmath import pow2_floor

        k = min(pow2_floor(deepest), self.max_blocks_per_step)
        width = next(w for w in self._slot_widths if w >= len(ready))
        rows = width * self.channels
        served = []
        x = np.zeros((rows, k * self.config.block_in), np.float32)
        tails = np.zeros((rows, self.config.halo_in), np.float32)
        for slot, _a in ready:
            taken = slot.take_blocks(k)
            if taken is None:
                continue
            frames, valid, ts = taken
            r0 = len(served) * self.channels
            x[r0:r0 + self.channels] = frames
            tails[r0:r0 + self.channels] = slot.tail
            # Host-side tail update from the REAL consumed frames only
            # (the zero pad never enters the stream history).
            joined = np.concatenate([slot.tail, frames[:, :valid]], axis=1)
            slot.tail = joined[:, -self.config.halo_in:]
            slot.pending_steps += 1
            served.append((slot, r0, valid, ts))
        if not served:
            return None
        return x, tails, served

    def _to_device(self, arr: np.ndarray):
        """Host -> device transfer of a step input: plain put on one
        chip, row-sharded put over the serve mesh otherwise (dim 0 =
        slot rows; the spectrum stays replicated)."""
        import jax
        import jax.numpy as jnp

        if self._sharding is None:
            return jnp.asarray(arr)
        return jax.device_put(arr, self._sharding)

    def _dispatch_fades(self, tj, xj, served) -> tuple[dict, list]:
        """Old-spectrum prefix dispatches for fading served slots
        (dispatcher thread only).

        Streams mid-crossfade need this step's first n output samples
        under the PRE-swap spectrum. The overlap-save tail is
        input-domain — identical for both spectra — so one extra narrow
        dispatch over the power-of-two block prefix covering the deepest
        fade window reproduces the old output exactly (engine fade
        machinery generalized to the serve row batch; fading slots are
        grouped per distinct old spectrum, one dispatch per group).
        Returns (fade_handles, served entries extended with fade info).
        """
        from totton_tpu.utils.intmath import pow2_ceil

        total = self._swap_fade_frames
        groups: dict[int, list] = {}
        out = []
        for slot, r0, valid, ts in served:
            fade = None
            if slot.fade_from is not None and total:
                n = min(total - slot.fade_pos, valid * self.config.ratio)
                if n > 0:
                    key = id(slot.fade_from)
                    g = groups.setdefault(key, [slot.fade_from, 0])
                    g[1] = max(g[1], n)
                    fade = (key, n, slot.fade_pos, total)
                    slot.fade_pos += n
                if slot.fade_pos >= total:
                    slot.fade_from = None
                    slot.fade_pos = 0
            out.append((slot, r0, valid, ts, fade))
        handles = {}
        for key, (spec, n_max) in groups.items():
            # Prefix width: pow2 blocks covering the deepest window (the
            # same warmed shape universe — n <= valid*ratio bounds it by
            # this step's own depth). Block j depends only on input up to
            # (j+1)*block_in, so the prefix slice is exact.
            nb = pow2_ceil(-(-n_max // self.config.block_size))
            handles[key] = self._step(tj, xj[:, :nb * self.config.block_in],
                                      spec)[0]
        return handles, out

    def _drain_one(self, inflight: list) -> None:
        y_dev, fades, served = inflight.pop(0)
        # Decrement pending_steps for EVERY served slot up front: if the
        # device fetch below raises (runtime fault), no slot is left with
        # a phantom in-flight step that would block its release forever.
        for slot, *_rest in served:
            slot.pending_steps -= 1
        t0 = time.monotonic()
        try:
            y = np.asarray(y_dev)
            if os.environ.get("TOTTON_SERVE_DEBUG_TIMING"):
                log.warning("timing: drain %.1f ms (y %s %s)",
                            (time.monotonic() - t0) * 1e3, y.shape, y.dtype)
            olds = {key: np.asarray(h) for key, h in fades.items()}
        except Exception:
            # Device fetch failed: these streams' audio now has a hole —
            # cut them (clients reconnect) instead of sending a gap.
            for slot, *_rest in served:
                self._cut(slot, "device step fetch failed")
            raise
        with self.stats.lock:
            self.stats.drain_wall_s += time.monotonic() - t0
        for slot, r0, valid, ts, fade in served:
            if slot.sock is None or slot.closing.is_set():
                continue  # stream gone mid-flight: discard its rows
            # COPY the slot's rows (np.array, not ascontiguousarray: the
            # r0=0 slice is already contiguous, where ascontiguousarray
            # returns a read-only VIEW that pins the whole batched step
            # array in the client's queue and rejects the fade mix).
            out = np.array(
                y[r0:r0 + self.channels, : valid * self.config.ratio])
            if fade is not None:
                # Linear crossfade old -> new; ramp position carries
                # across this stream's dispatches (same convention as
                # engine.StreamingUpsampler: sample 0 is pure old).
                key, n, pos0, total = fade
                ramp = (pos0 + np.arange(n, dtype=np.float32)) / total
                out[:, :n] = (
                    olds[key][r0:r0 + self.channels, :n] * (1.0 - ramp)
                    + out[:, :n] * ramp)
            if self.device_pcm and out.dtype != np.int16:
                # Fade steps stayed float on device; quantize with the
                # bit-exact host twin so the output dtype contract holds.
                from totton_tpu.io.pcm import quantize_s16_host

                out = quantize_s16_host(out)
            # Account the blocks BEFORE put() (rolled back on Full): if
            # the writer dequeued+decremented before a post-put increment,
            # the clamped decrement would leave a phantom block that never
            # drains and eventually gates ready() forever.
            nblocks = -(-valid // self.config.block_in)
            with slot.out_lock:
                slot.out_blocks += nblocks
            try:
                # Never reached by a healthy stream: ready() gates on the
                # soft block limit and the hard capacity covers in-flight
                # headroom. A hit means the writer is stalled on a dead
                # peer — cut it rather than stall every other stream.
                slot.out.put(out, timeout=2.0)
            except queue.Full:
                with slot.out_lock:
                    slot.out_blocks -= nblocks
                self._cut(slot, "output queue stalled")
                continue
            # Per-block latency: input-ready (block's last sample arrived)
            # -> output-queued (just now). Reservoir-capped; dispatcher
            # thread only.
            now = time.monotonic()
            slot.lat_ms.extend((now - t) * 1e3 for t in ts)
            if len(slot.lat_ms) > 512:
                del slot.lat_ms[:len(slot.lat_ms) - 512]
            with self.stats.lock:
                self.stats.frames_out += out.shape[1]

    def _finish_eof_slots(self) -> None:
        """Tell writers of fully-drained EOF streams to finish. A slot is
        done when the client half-closed, no input remains to flush, and
        every dispatched step has been drained to its writer queue.
        (Dispatcher-thread only: pending_steps/flushed/finished are
        single-threaded here.)"""
        for slot in self.slots:
            if slot.sock is None or slot.finished:
                continue
            if slot.pending_steps > 0:
                continue
            if slot.closing.is_set():
                # CUT stream: finish unconditionally — its leftover input
                # backlog will never be consumed (ready() is false), and
                # without the sentinel a writer parked on an EMPTY queue
                # (stream cut before any output) would never detach and
                # the slot would leak forever.
                pass
            else:
                if not slot.eof:
                    continue
                with slot.buf_lock:
                    empty = slot.buf.shape[1] == 0
                if not (empty or slot.flushed):
                    continue
            slot.finished = True
            try:
                slot.out.put_nowait(None)  # writer drains then detaches
            except queue.Full:
                slot.finished = False  # stalled writer: cut, retry
                self._cut(slot, "EOF finish blocked by stalled writer")

    def _dispatcher(self) -> None:
        depth = 2
        inflight: list[tuple] = []
        last_stats = 0.0
        failures = 0

        while not self._stop.is_set():
            # Guard the whole iteration: an unexpected error (e.g. a jax
            # runtime fault in _step) must not silently kill the dispatcher
            # while the acceptor keeps admitting clients that then hang
            # forever. Transients are logged and retried; persistent
            # failure stops the server VISIBLY (wait() unblocks, the CLI
            # exits nonzero).
            try:
                # Queued control changes (set_eq / load_filter /
                # soft_reset) land at step boundaries, never mid-step.
                self._apply_pending_control()
                batch = self._gather()
                if batch is None:
                    while inflight:
                        self._drain_one(inflight)
                    self._finish_eof_slots()
                    self._release_detached_slots()
                    now = time.monotonic()
                    if now - last_stats > 0.5:
                        self._write_stats()
                        last_stats = now
                    if self._kick.wait(timeout=0.05):
                        self._kick.clear()
                    # NB: failures does NOT reset here — idle iterations
                    # say nothing about the device. Only a successful
                    # dispatch clears the strike count, so a persistent
                    # fault that cuts each client (going idle in
                    # between) still trips the breaker instead of
                    # cutting every future client forever.
                    continue
                x, tails, served = batch
                try:
                    _t0 = time.monotonic()
                    tj, xj = self._to_device(tails), self._to_device(x)
                    y_dev, _ = self._step(tj, xj, self._spectrum)
                    _t1 = time.monotonic()
                    fades, served = self._dispatch_fades(tj, xj, served)
                    if os.environ.get("TOTTON_SERVE_DEBUG_TIMING"):
                        log.warning("timing: dispatch %.1f ms (x %s)",
                                    (_t1 - _t0) * 1e3, x.shape)
                    if self.device_pcm and not fades:
                        # Elementwise on-device quantize (sharding-
                        # preserving) so the drain moves int16. Fade
                        # steps keep float and quantize on the host
                        # after mixing.
                        from totton_tpu.ops import device_pcm as _dp

                        y_dev = _dp.quantize_s16(y_dev)
                except Exception:
                    # The gathered slots' pending_steps were already
                    # incremented and their input consumed; without this
                    # rollback a fault here would leak them forever
                    # (never released, never EOF-finished, drain() never
                    # completes) — the outer handler only walks entries
                    # that made it into inflight.
                    for slot, *_rest in served:
                        slot.pending_steps -= 1
                        self._cut(slot, "step dispatch failed")
                    raise
                inflight.append((y_dev, fades, served))
                shape_key = (f"{x.shape[0] // self.channels}x"
                             f"{x.shape[1] // self.config.block_in}")
                with self.stats.lock:
                    self.stats.steps += 1
                    self.stats.steps_by_shape[shape_key] = (
                        self.stats.steps_by_shape.get(shape_key, 0) + 1)
                while len(inflight) > depth:
                    self._drain_one(inflight)
                self._finish_eof_slots()
                self._release_detached_slots()
                # Stats refresh on the BUSY path too (same 0.5 s throttle):
                # under sustained load the idle branch never runs, which is
                # exactly when the operator surface needs fresh numbers.
                now = time.monotonic()
                if now - last_stats > 0.5:
                    self._write_stats()
                    last_stats = now
                failures = 0
            except Exception:
                log.exception("serve: dispatcher iteration failed")
                failures += 1
                # Steps still in flight are unsalvageable here; release
                # their slots' in-flight accounting and cut those streams
                # (their audio has a hole anyway) so the slots recycle.
                for _y_dev, _fades, served in inflight:
                    for slot, *_rest in served:
                        slot.pending_steps -= 1
                        self._cut(slot, "dispatcher failure")
                inflight.clear()
                if failures >= 3:
                    log.error("serve: dispatcher failing persistently; "
                              "stopping server")
                    self.failed = True
                    self._stop.set()
        while inflight:
            try:
                self._drain_one(inflight)
            except Exception:
                log.exception("serve: final drain failed")

    def _slot_status(self, s: StreamSlot) -> dict:
        """One stream's stats row: counters + live backlog + the
        input-ready -> output-queued latency distribution."""
        row = dict(slot=s.index, **s.stats.to_json())
        with s.buf_lock:
            row["input_backlog_blocks"] = s.buf.shape[1] // s.block_in
        with s.out_lock:
            row["output_backlog_blocks"] = s.out_blocks
        lat = list(s.lat_ms)
        if lat:
            q50, q95 = np.percentile(lat, [50, 95])
            row["latency_ms"] = {"p50": round(float(q50), 3),
                                 "p95": round(float(q95), 3),
                                 "max": round(float(max(lat)), 3)}
        return row

    def _write_stats(self) -> None:
        if not self._stats_path:
            return
        active = sum(1 for s in self.slots if s.sock is not None)
        per_stream = [self._slot_status(s)
                      for s in self.slots if s.sock is not None]
        tmp = self._stats_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self.stats.to_json(active, per_stream), f)
            os.replace(tmp, self._stats_path)
        except OSError:
            pass

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._srv = _listen(self.spec, backlog=max(self.max_streams, 16))
        # Warm every step shape the adaptive dispatcher can use
        # ({1, 2, ..., max_blocks_per_step} blocks — logarithmic set)
        # before accepting: a first-client compile would stall every
        # later join too.
        import jax

        for width in self._slot_widths:
            rows = width * self.channels
            zt = self._to_device(
                np.zeros((rows, self.config.halo_in), np.float32))
            k = 1
            while k <= self.max_blocks_per_step:
                z = self._to_device(
                    np.zeros((rows, k * self.config.block_in), np.float32))
                y0 = self._step(zt, z, self._spectrum)[0]
                if self.device_pcm:
                    from totton_tpu.ops import device_pcm as _dp

                    y0 = _dp.quantize_s16(y0)
                np.asarray(y0)
                k *= 2
        for target, name in ((self._acceptor, "totton-serve-accept"),
                             (self._dispatcher, "totton-serve-dispatch")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        log.info("serve: listening on %s (%d slots, %d Hz -> %d Hz)",
                 self.spec.raw, self.max_streams, self.sample_rate,
                 self.sample_rate * self.config.ratio)

    def drain(self, timeout_s: float | None = None) -> bool:
        """Graceful shutdown, phase 1: stop ACCEPTING but let active
        streams finish (clients that half-closed get their full output;
        long-lived clients keep streaming until they disconnect or the
        timeout). Returns True when every slot drained in time. Call
        stop() afterwards either way."""
        if self._srv is not None:
            try:
                self._srv.close()  # acceptor thread exits on OSError
            except OSError:
                pass
            if self.spec.family == socket.AF_UNIX:
                try:
                    os.unlink(self.spec.path)
                except FileNotFoundError:
                    pass
            self._srv = None
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while any(s.sock is not None or not s.detached or s.pending_steps
                  for s in self.slots):
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        return True

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            if self.spec.family == socket.AF_UNIX:
                try:
                    os.unlink(self.spec.path)
                except FileNotFoundError:
                    pass
        for slot in self.slots:
            slot.closing.set()
            sock = slot.sock  # writers' _detach may null it concurrently
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            try:
                slot.out.put_nowait(None)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=10)
        self._write_stats()

    def wait(self, timeout: float | None = None) -> None:
        self._stop.wait(timeout)
