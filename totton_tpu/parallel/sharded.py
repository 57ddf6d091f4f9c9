"""Sharded overlap-save upsampling: channels x time-blocks over a Mesh.

The hot path under shard_map:

  - input x[C, T] sharded PartitionSpec('channel', 'time');
  - each time shard needs the trailing halo_in input samples of its left
    neighbor -> one jax.lax.ppermute per step (halo_in floats per channel,
    e.g. 5000 * 4 B at 16x/80k taps);
  - time shard 0 takes the carried stream tail instead (zeros at start);
  - then the local compute is exactly the single-chip batched kernel
    (totton_tpu.ops.overlap_save) — no other communication; output lands
    sharded the same way.

The filter spectrum is replicated (512 KB at fft 131072) and
stays a traced argument: filter RELOAD / EQ hot-swap never recompiles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from totton_tpu.filters.sidecar import LoadedFilter
from totton_tpu.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    make_block_step,
    upsample_blocks,
)

#: Default lead time (in engine steps) a scheduled hot-swap gives the
#: control fan-out: the leader stamps apply_at_step = current + margin so
#: every process (whose PUB subscription delivers in ~ms while a live
#: step spans >= 72 ms of audio) schedules the same spectrum for the same
#: step boundary. Generous by construction; a process that still misses
#: the deadline applies the swap at its next step, counts
#: swap_deadline_misses, and logs — bounded divergence, never a deadlock
#: (the fade path is collective-free, see _dispatch_fade).
SWAP_MARGIN_STEPS = 8


def _local_step(tail, x_local, spectrum, cfg: OverlapSaveConfig):
    """Per-shard body (runs under shard_map).

    tail: [C_local, halo_in] global stream history (used by time shard 0);
    x_local: [C_local, T_local] this shard's fresh input;
    returns y_local [C_local, T_local * ratio].
    """
    n_time = jax.lax.axis_size("time")
    t_idx = jax.lax.axis_index("time")
    halo_in = cfg.halo_in

    if halo_in > 0:
        local_tail = x_local[:, -halo_in:]
        if n_time > 1:
            # Left neighbor's trailing samples; shard 0 receives zeros
            # (perm has no source for it), then selects the stream tail.
            received = jax.lax.ppermute(
                local_tail,
                axis_name="time",
                perm=[(i, i + 1) for i in range(n_time - 1)],
            )
            halo = jnp.where(t_idx == 0, tail, received)
        else:
            halo = tail
        xin = jnp.concatenate([halo, x_local], axis=-1)
    else:
        xin = x_local

    return upsample_blocks(xin, spectrum, cfg)


@functools.lru_cache(maxsize=32)
def make_sharded_step(cfg: OverlapSaveConfig, mesh: Mesh):
    """Jitted sharded streaming step for a fixed geometry and mesh.

    Returns step(tail, x, spectrum) -> (y, new_tail) where
      x:    [C, T] float32, T divisible by (block_in * mesh 'time' size),
            C divisible by mesh 'channel' size; sharded ('channel','time');
      tail: [C, halo_in] replicated along 'time';
      y:    [C, T * ratio] sharded ('channel', 'time').

    The updated tail is a plain slice of the global input (the stream's last
    halo_in samples) — computed outside shard_map so its value never depends
    on cross-shard replication semantics.
    """
    if mesh.devices.size == 1:
        # Single-device mesh: the shard_map body degenerates to
        # halo=tail + concat + the plain kernel (n_time=1 has no
        # ppermute and t_idx==0 always selects the tail). Emit the
        # identical math without the shard_map wrapper and its fixed
        # per-step cost; make_block_step's program has exactly this body.
        return make_block_step(cfg)
    body = functools.partial(_local_step, cfg=cfg)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("channel", None), P("channel", "time"), P()),
        out_specs=P("channel", "time"),
    )

    @jax.jit
    def step(tail, x, spectrum):
        y = sharded(tail, x, spectrum)
        new_tail = x[:, -cfg.halo_in :] if cfg.halo_in else tail
        return y, new_tail

    return step


def _check_shapes(cfg: OverlapSaveConfig, mesh: Mesh, channels: int, t: int):
    n_ch = mesh.shape["channel"]
    n_t = mesh.shape["time"]
    if channels % n_ch != 0:
        raise ValueError(
            f"channels ({channels}) not divisible by mesh channel axis ({n_ch})"
        )
    shard_t = t // n_t
    if t % n_t != 0 or shard_t % cfg.block_in != 0 or shard_t == 0:
        raise ValueError(
            f"input length {t} must split into {n_t} time shards of whole "
            f"blocks (block_in={cfg.block_in})"
        )
    if cfg.halo_in > shard_t:
        raise ValueError(
            f"per-shard input ({shard_t}) shorter than the halo "
            f"({cfg.halo_in}); enlarge the per-step input or shrink the mesh"
        )


def sharded_upsample(
    x: np.ndarray,
    filt: LoadedFilter,
    mesh: Mesh,
    eq_response: np.ndarray | None = None,
) -> np.ndarray:
    """One-shot sharded upsample of [C, T] (T a multiple of
    block_in * n_time). Returns [C, T * ratio]."""
    cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
    x = jnp.asarray(x, dtype=jnp.float32)
    _check_shapes(cfg, mesh, x.shape[0], x.shape[1])
    spectrum = filter_spectrum(filt.taps, cfg.fft_size, eq_response)
    step = make_sharded_step(cfg, mesh)
    tail = jnp.zeros((x.shape[0], cfg.halo_in), jnp.float32)
    x = jax.device_put(x, NamedSharding(mesh, P("channel", "time")))
    y, _ = step(tail, x, spectrum)
    return np.asarray(y)


class ShardedUpsampler:
    """Streaming facade over the sharded step (multi-chip analog of
    engine.StreamingUpsampler)."""

    def __init__(
        self,
        filt: LoadedFilter,
        mesh: Mesh,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
        swap_fade_frames: int = 0,
        device_pcm=None,
    ) -> None:
        if swap_fade_frames < 0:
            raise ValueError(
                f"swap_fade_frames must be >= 0: {swap_fade_frames}")
        if device_pcm is not None:
            from totton_tpu.io.pcm import PcmFormat

            if device_pcm is not PcmFormat.S16_LE:
                raise ValueError(
                    f"device_pcm supports S16_LE only, got {device_pcm}")
        # Device-PCM mode (ops/device_pcm.py): the elementwise quantize is
        # applied to the SHARDED step output, so every process's drain
        # (_local_output) moves int16 — the multi-host analog of the plain
        # engine's halved device->host transfer. Undithered only: jax
        # PRNG sampling partitioned over a mesh does not produce a
        # layout-independent noise stream, and the sharded oracle tests
        # assert exact single-device equality; dithering stays with the
        # sink on sharded deployments.
        self.device_pcm = device_pcm
        # Click-free hot swap, same contract as StreamingUpsampler: fade
        # the first swap_fade_frames output samples after a spectrum swap
        # from old to new. The ramp position carries across steps
        # (_fade_pos), so a fade longer than one step's output continues
        # where it left off instead of truncating to a mid-ramp jump —
        # the same carry StreamingUpsampler has (a sharded step usually
        # emits >= 51072 samples, but small test geometries and long
        # fades do spill over). The old-spectrum output for the fade
        # window is computed by a LOCAL, collective-free program
        # (_dispatch_fade) on the process owning time column 0 — never by
        # re-running the sharded (ppermute-carrying) step — so fades can
        # not cause SPMD divergence and cost ~1 block instead of a full
        # re-dispatch.
        self._swap_fade_frames = swap_fade_frames
        self._fade_from = None
        self._fade_pos = 0
        self._fade_total = None
        # Step-synchronized hot swap (multi-host): every dispatch advances
        # step_index in lockstep across processes (each participates in
        # every collective step), so a swap scheduled for the same
        # apply_at_step lands at the SAME output sample everywhere —
        # closing the eventually-consistent divergence window of
        # immediate control fan-out.
        self.step_index = 0
        self._pending_swap: tuple | None = None
        self.swap_deadline_misses = 0
        self.config = OverlapSaveConfig.from_sidecar(filt.sidecar)
        self.mesh = mesh
        self._filter = filt
        self._channels = channels
        self._spectrum = filter_spectrum(
            filt.taps, self.config.fft_size, eq_response
        )
        self._step = make_sharded_step(self.config, mesh)
        self._tail = jnp.zeros((channels, self.config.halo_in), jnp.float32)
        n_time = mesh.shape["time"]
        #: fresh input samples required per process_block call
        self.step_input_frames = self.config.block_in * n_time
        # Per-shard input must cover the halo; this multiplier makes
        # block_input_frames a safe dispatch granule for stream sessions.
        mult = 1
        while (mult * self.config.block_in) < self.config.halo_in:
            mult *= 2
        #: safe dispatch granule (multiple of step_input_frames whose
        #: per-shard length covers the halo)
        self.block_input_frames = self.step_input_frames * mult
        self._sharding = NamedSharding(mesh, P("channel", "time"))
        self._local_channel_rows, self._local_time_cols = (
            self._resolve_local_block(mesh))
        if channels % mesh.shape["channel"] != 0:
            raise ValueError(
                f"channels ({channels}) not divisible by mesh channel "
                f"axis ({mesh.shape['channel']})"
            )
        #: audio channels THIS process feeds/drains (= all of them on a
        #: single process; its channel rows' share on multi-process)
        self.local_channels = (
            channels // mesh.shape["channel"] * len(self._local_channel_rows)
        )
        import threading

        self._lock = threading.Lock()
        #: does this process hold global time column 0 (the fade window)?
        self._owns_col0 = (not self._local_time_cols
                           or self._local_time_cols[0] == 0)
        # Local fade program: the PLAIN single-device block step, used
        # only to recompute the fade window's old-spectrum output from
        # the replicated stream tail + this process's input prefix — no
        # collectives, so a fade can never diverge the mesh. Warmed at
        # construction (1-block shape) so a live fade never compiles
        # mid-stream.
        self._fade_step = None
        if swap_fade_frames > 0 and self._owns_col0:
            from totton_tpu.engine.upsampler import fade_warm_widths

            self._fade_step = make_block_step(self.config)
            zt = jnp.zeros((self.local_channels, self.config.halo_in),
                           jnp.float32)
            # Warm every power-of-two prefix width the fade window can
            # dispatch so a live fade never compiles mid-stream.
            for nb in fade_warm_widths(swap_fade_frames,
                                       self.config.block_size):
                z = jnp.zeros(
                    (self.local_channels, nb * self.config.block_in),
                    jnp.float32)
                jax.block_until_ready(
                    self._fade_step(zt, z, self._spectrum)[0])

    @classmethod
    def local_channel_count(cls, mesh: Mesh, channels: int) -> int:
        """Channels THIS process will feed/drain for a global channel
        count on this mesh — the pre-construction helper for callers that
        must size their IO endpoints before building the engine (the CLI
        opens sources first). Validates the same contracts the
        constructor enforces."""
        if channels % mesh.shape["channel"] != 0:
            raise ValueError(
                f"channels ({channels}) not divisible by mesh channel "
                f"axis ({mesh.shape['channel']})"
            )
        rows, _cols = cls._resolve_local_block(mesh)
        local = channels // mesh.shape["channel"] * len(rows)
        if local == 0:
            raise ValueError(
                f"process {jax.process_index()} owns no channel rows for "
                f"channels={channels} on mesh {dict(mesh.shape)}"
            )
        return local

    @staticmethod
    def _resolve_local_block(mesh: Mesh) -> tuple[list[int], list[int]]:
        """(channel rows, time cols) of the mesh owned by THIS process.

        The per-process ingest contract: each process's devices form a
        contiguous (channel rows x time cols) rectangle, so every host
        feeds exactly the channel/time block its own devices compute —
        whole time columns for time-sharded streaming, whole channel rows
        for multi-host channel-only sharding. make_mesh lays multi-host
        grids out this way.
        """
        if jax.process_count() == 1:
            return (list(range(mesh.devices.shape[0])),
                    list(range(mesh.shape["time"])))
        me = jax.process_index()
        cells = [
            (r, t)
            for r in range(mesh.devices.shape[0])
            for t in range(mesh.devices.shape[1])
            if mesh.devices[r, t].process_index == me
        ]
        rows = sorted({c[0] for c in cells})
        cols = sorted({c[1] for c in cells})
        rect = (
            rows == list(range(rows[0], rows[0] + len(rows)))
            and cols == list(range(cols[0], cols[0] + len(cols)))
            and len(cells) == len(rows) * len(cols)
        ) if cells else False
        if not rect:
            raise ValueError(
                "multi-host ingest needs each process's devices to form a "
                f"contiguous channel x time rectangle; process {me} owns "
                f"cells {cells} (build the mesh with parallel.make_mesh)"
            )
        return rows, cols

    @property
    def ratio(self) -> int:
        return self.config.ratio

    @property
    def channels(self) -> int:
        return self._channels

    @property
    def local_block_input_frames(self) -> int:
        """This process's share of one dispatch granule: the input frames a
        stream session must feed process_block per call. Equals
        block_input_frames single-process; on a multi-process mesh it is
        the granule's slice over this process's time columns."""
        n_time = self.mesh.shape["time"]
        return (self.block_input_frames // n_time
                * len(self._local_time_cols))

    def reset(self) -> None:
        with self._lock:
            self._tail = jnp.zeros_like(self._tail)
            self._fade_from = None
            self._fade_pos = 0
            self._fade_total = None

    def _note_swap(self, old_spectrum) -> None:
        """Arm the crossfade (keep the ORIGINAL pre-swap spectrum if several
        swaps land between two steps).

        IMMEDIATE multi-process swaps stay fade-less: each process's
        control thread applies them at an uncoordinated step, so the fade
        window would start at different output samples per process. Use
        schedule_swap (step-synchronized, published with apply_at_step)
        for multi-host click-free swaps — its deterministic boundary arms
        the fade on every process at the same sample, and the fade's
        old-spectrum output is computed by a local collective-free
        program (_dispatch_fade), so there is no SPMD hazard either way.
        Single-process meshes keep the immediate click-free fade.
        """
        if jax.process_count() > 1:
            return
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = old_spectrum
            self._fade_pos = 0

    def schedule_swap(
        self,
        filt: LoadedFilter | None = None,
        eq_response: np.ndarray | None = None,
        apply_at_step: int | None = None,
        margin_steps: int = SWAP_MARGIN_STEPS,
    ) -> int:
        """Queue a filter/EQ swap to land at an exact step boundary.

        The LEADER calls this without apply_at_step (stamping
        current + margin_steps) and publishes the returned step with the
        control event; FOLLOWERS call it with the published value, so the
        swap lands at the SAME output sample on every process — no
        eventually-consistent window, and the crossfade (when configured)
        is armed at that boundary on every process deterministically
        (reference analog: its RELOAD restarts the container; multi-host
        doesn't exist there at all, SURVEY.md §2.3).

        A newer scheduled swap replaces a still-pending one. If the
        deadline has already passed when the swap is applied (extreme
        control-plane lag), it applies at the next boundary instead —
        counted in swap_deadline_misses and logged, bounded divergence,
        never a deadlock (the fade path is collective-free).

        Returns the step index the swap will apply at.
        """
        lf = filt or self._filter
        cfg = OverlapSaveConfig.from_sidecar(lf.sidecar)
        if cfg != self.config:
            raise ValueError(
                "sharded engine filter swap requires identical "
                f"overlap-save geometry (have {self.config}, new {cfg})"
            )
        spectrum = filter_spectrum(lf.taps, cfg.fft_size, eq_response)
        with self._lock:
            if apply_at_step is None:
                apply_at_step = self.step_index + margin_steps
            self._pending_swap = (apply_at_step, filt, spectrum)
        return apply_at_step

    def _apply_pending_swap_locked(self) -> None:
        """Apply a due scheduled swap at this step boundary (lock held)."""
        if self._pending_swap is None:
            return
        apply_at, filt, spectrum = self._pending_swap
        if self.step_index < apply_at:
            return
        self._pending_swap = None
        if self.step_index > apply_at:
            self.swap_deadline_misses += 1
            import sys

            print(
                f"sharded engine: scheduled swap missed its step deadline "
                f"(apply_at={apply_at}, now={self.step_index}) — applied "
                f"late; divergence window of "
                f"{self.step_index - apply_at} step(s)", file=sys.stderr)
        if filt is not None:
            self._filter = filt
        # Deterministic boundary -> the fade is safe on every process
        # (bypass _note_swap's immediate-swap multi-process gate).
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = self._spectrum
            self._fade_pos = 0
        self._spectrum = spectrum

    def _local_tail_host(self, tail) -> np.ndarray:
        """This process's channel rows of the carried tail as numpy (input
        to the local fade program)."""
        if jax.process_count() == 1:
            return np.asarray(tail)
        cpr = self._channels // self.mesh.shape["channel"]
        lo = self._local_channel_rows[0] * cpr
        shards = {}
        for s in tail.addressable_shards:
            shards[s.index[0].start or 0] = np.asarray(s.data)
        starts = sorted(shards)
        rows = np.concatenate([shards[k] for k in starts], axis=0)
        base = starts[0]
        return rows[lo - base: lo - base + self.local_channels]

    def set_eq(self, eq_response: np.ndarray | None) -> None:
        spectrum = filter_spectrum(
            self._filter.taps, self.config.fft_size, eq_response
        )
        with self._lock:
            self._note_swap(self._spectrum)
            self._spectrum = spectrum

    def set_dither(self, enabled: bool) -> bool:
        """Sharded device-PCM is undithered by design (see __init__ note);
        the live dither toggle has nothing to switch here."""
        return False

    def load_filter(
        self, filt: LoadedFilter, eq_response: np.ndarray | None = None
    ) -> None:
        """Swap filters (same-geometry swaps never recompile)."""
        cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
        # Validate BEFORE touching any state: a rejected swap must leave
        # filter/spectrum/config consistent (a later set_eq rebuilds the
        # spectrum from self._filter.taps).
        if cfg != self.config:
            raise ValueError(
                "sharded engine filter swap requires identical "
                f"overlap-save geometry (have {self.config}, new {cfg})"
            )
        spectrum = filter_spectrum(filt.taps, cfg.fft_size, eq_response)
        with self._lock:
            self._filter = filt
            self._note_swap(self._spectrum)
            self._spectrum = spectrum

    def _put(self, x: np.ndarray):
        """Host -> device transfer of one step's input.

        Single process: device_put of the global [C, T] array. Multi
        process: ``x`` is this process's LOCAL block — its channel rows'
        share over its time span ([local_channels, T_local]);
        jax.make_array_from_process_local_data assembles the global array
        from every host's local feed — no host ever materializes the
        global signal (the reference has no multi-host path at all;
        SURVEY.md section 2.3).
        """
        n_time = self.mesh.shape["time"]
        n_local = len(self._local_time_cols)
        if jax.process_count() == 1:
            return jax.device_put(jnp.asarray(x), self._sharding), x.shape[1]
        if x.shape[1] % n_local != 0:
            raise ValueError(
                f"local input length {x.shape[1]} must split across "
                f"{n_local} local time shards"
            )
        global_t = x.shape[1] // n_local * n_time
        arr = jax.make_array_from_process_local_data(
            self._sharding, x, (self._channels, global_t)
        )
        return arr, global_t

    def _local_output(self, y) -> np.ndarray:
        """This process's contiguous span of the sharded output."""
        if jax.process_count() == 1:
            return np.asarray(y)
        shards = sorted(y.addressable_shards, key=lambda s: (
            s.index[0].start or 0, s.index[1].start or 0))
        by_col: dict[int, list] = {}
        for s in shards:
            by_col.setdefault(s.index[1].start or 0, []).append(s)
        cols = []
        for start in sorted(by_col):
            col = np.concatenate([np.asarray(s.data) for s in by_col[start]],
                                 axis=0)
            cols.append(col)
        return np.concatenate(cols, axis=1)

    def dispatch_block(self, x: np.ndarray):
        """Submit one step of input to the mesh; returns an opaque handle
        for fetch() WITHOUT waiting for device compute (same two-phase
        contract as StreamingUpsampler.dispatch_block — the carried tail
        is a device value, so consecutive dispatches chain on-device and
        stream sessions overlap step i+1's transfer/dispatch with step
        i's drain).

        Single process: x is the global [C, T] block. Multi process: x is
        this process's local block [local_channels, T_local] (its channel
        rows over its time span).

        The host->device transfer happens OUTSIDE the dispatch lock (the
        backend dispatches asynchronously); the lock only orders tail
        updates and filter/EQ hot-swaps against dispatch, and fades are
        bookkept here (dispatch order = output order).
        """
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != self.local_channels:
            raise ValueError(
                f"expected [local_channels={self.local_channels}, n], "
                f"got {x.shape}"
            )
        xs, global_t = self._put(x)
        if global_t % self.step_input_frames != 0 or global_t == 0:
            raise ValueError(
                f"global input length {global_t} must be a positive multiple "
                f"of step_input_frames {self.step_input_frames}"
            )
        _check_shapes(self.config, self.mesh, self._channels, global_t)
        with self._lock:
            self._apply_pending_swap_locked()
            tail_before = self._tail
            y, self._tail = self._step(tail_before, xs, self._spectrum)
            self.step_index += 1
            fade = None
            if self._fade_from is not None:
                # Fade window = the first n LOCAL output samples of the
                # post-swap step(s), which live in global time column 0.
                # The old-spectrum output for that window is recomputed by
                # the LOCAL plain block step from the replicated stream
                # tail + this process's input prefix (ceil(n/block_size)
                # blocks, usually one) — a single-device program with no
                # collectives, so no process can diverge the mesh, and
                # the cost is ~1 block instead of re-dispatching the whole
                # step. Ramp convention matches StreamingUpsampler:
                # starts at exactly 0, position carried across steps; the
                # position bookkeeping runs identically on EVERY process
                # (local output spans are equal) so fade state machines
                # stay in lockstep; only the column-0 owner computes/mixes.
                local_out = x.shape[1] * self.config.ratio
                if self._fade_total is None:
                    self._fade_total = self._swap_fade_frames
                    if (jax.process_count() > 1
                            and self.mesh.shape["time"] > 1):
                        # Time-sharded multi-process: samples beyond this
                        # process's per-step span belong to ANOTHER
                        # process's time columns, which hold no y_old —
                        # confine the ramp to column 0's span so it
                        # completes exactly at the span boundary (the
                        # neighbor's pure-new samples continue seamlessly)
                        # instead of mixing old audio at wrong positions.
                        self._fade_total = min(self._fade_total, local_out)
                total = self._fade_total
                n = min(total - self._fade_pos, local_out)
                y_old = None
                if self._owns_col0 and self._fade_step is not None:
                    from totton_tpu.engine.upsampler import _fade_prefix

                    # Power-of-two prefix width keeps the fade-shape
                    # universe to the warmed set — see _fade_prefix.
                    tail_local = self._local_tail_host(tail_before)
                    y_old, _ = self._fade_step(
                        jnp.asarray(tail_local),
                        _fade_prefix(x, n, self.config.block_size,
                                     self.config.block_in),
                        self._fade_from)
                ramp = (self._fade_pos
                        + np.arange(n, dtype=np.float32)) / total
                fade = (y_old, ramp, n)
                self._fade_pos += n
                if self._fade_pos >= total:
                    self._fade_from = None
                    self._fade_pos = 0
                    self._fade_total = None
            if self.device_pcm is not None and fade is None:
                # Quantize the sharded output on-device (elementwise:
                # sharding is preserved) so the per-process drain moves
                # int16. Fade steps mix old/new on the host in float and
                # quantize in fetch().
                from totton_tpu.ops import device_pcm as _dp

                y = _dp.quantize_s16(y)
        return (y, fade)

    def fetch(self, handle) -> np.ndarray:
        """Block for a dispatched step's LOCAL output (device->host).
        Fetch in dispatch order (fade ramps are stateful in that order)."""
        y, fade = handle
        out = self._local_output(y)
        if fade is not None and fade[0] is not None:
            # The fade window starts at global output position 0 of the
            # first step after the swap; only the process owning time
            # column 0 holds that span, and only it computed the LOCAL
            # old-spectrum output (dispatch_block fade note).
            y_old, ramp, n = fade
            old = np.asarray(y_old)
            out = np.array(out)
            out[:, :n] = old[:, :n] * (1.0 - ramp) + out[:, :n] * ramp
        if self.device_pcm is not None and fade is not None:
            from totton_tpu.io.pcm import quantize_s16_host

            out = quantize_s16_host(out)
        return out

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """Upsample one step of input synchronously (dispatch + fetch).

        Single process: x is the global [C, T] block, returns [C, T*ratio].
        Multi process: x is this process's local block
        [local_channels, T_local], returns the matching
        [local_channels, T_local*ratio] output block.
        """
        return self.fetch(self.dispatch_block(x))
