"""StreamingUpsampler: the engine facade.

API parity with the reference engine's LoadFilter / ProcessBlock / Reset /
GetConfig surface (include/vulkan/vulkan_streaming_upsampler.h:30-34), built
on the batched JAX overlap-save ops. One instance serves *all* channels
(the reference clones one engine per channel,
src/alsa/alsa_streamer_main.cpp:248-250; here channels are just a batch axis
— and a sharding axis on multi-chip meshes).
"""

from __future__ import annotations

import threading

import numpy as np
import jax.numpy as jnp

from totton_tpu.filters.sidecar import LoadedFilter, load_filter
from totton_tpu.io.pcm import PcmFormat
from totton_tpu.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    make_block_step,
)


def _fade_width_blocks(n: int, block_size: int) -> int:
    """Dispatch width (in blocks) for a fade window of n output samples:
    ceil(n / block_size) rounded UP to a power of two, so the universe of
    fade dispatch shapes is {1, 2, 4, ...} — a logarithmic warm-up set
    instead of one shape per possible window remainder. Overlap-save
    block j depends only on input up to (j+1)*block_in, so zero-padding
    the input prefix to the rounded width cannot change the first n
    samples."""
    from totton_tpu.utils.intmath import pow2_ceil

    return pow2_ceil(-(-n // block_size))


def fade_warm_widths(fade_frames: int, block_size: int) -> list[int]:
    """Every dispatch width (in blocks) a fade of this length can use —
    the set sessions/engines must warm so a live crossfade never
    compiles mid-stream."""
    widths = []
    nb = _fade_width_blocks(fade_frames, block_size)
    while nb >= 1:
        widths.append(nb)
        nb //= 2
    return widths


def _fade_prefix(xj, n: int, block_size: int, block_in: int):
    """Power-of-two prefix of a dispatch's input covering a fade window
    of n output samples, zero-padded past the real input when the
    rounded width exceeds it (overlap-save block j depends only on input
    up to (j+1)*block_in, so the pad cannot change the first n
    samples)."""
    nb = _fade_width_blocks(n, block_size)
    need = nb * block_in
    pref = jnp.asarray(xj)[:, :need]
    if pref.shape[1] < need:
        pref = jnp.pad(pref, ((0, 0), (0, need - pref.shape[1])))
    return pref


class StreamingUpsampler:
    """Stateful block-streaming upsampler for a fixed channel count.

    State is just the last halo_in *input-rate* samples per channel (the
    reference carries taps-1 output-rate samples instead,
    vulkan_streaming_upsampler.cpp:571-594 — same information, ratio x
    smaller here).
    """

    def __init__(
        self,
        filt: LoadedFilter,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
        swap_fade_frames: int = 0,
        device_pcm: "PcmFormat | None" = None,
        pcm_dither: bool = False,
        pcm_seed: int | None = None,
    ) -> None:
        if channels < 1:
            raise ValueError(f"channels must be >= 1: {channels}")
        if swap_fade_frames < 0:
            raise ValueError(f"swap_fade_frames must be >= 0: {swap_fade_frames}")
        if device_pcm is not None and device_pcm is not PcmFormat.S16_LE:
            # s24/s32 transfer as int32 = 4 B/sample, same as float32 —
            # no device->host win, and their host paths carry the
            # reference-exact (and float64-dither) contracts. See
            # ops/device_pcm.py.
            raise ValueError(
                f"device_pcm supports S16_LE only, got {device_pcm}")
        self._filter = filt
        self._channels = channels
        self.config = OverlapSaveConfig.from_sidecar(filt.sidecar)
        self._spectrum = filter_spectrum(
            filt.taps, self.config.fft_size, eq_response
        )
        self._step = make_block_step(self.config)
        self._tail = jnp.zeros((channels, self.config.halo_in), jnp.float32)
        # Click-free hot swap: fade the first swap_fade_frames OUTPUT samples
        # of the dispatch after a same-geometry spectrum swap from the old
        # filter's output to the new one's (0 = abrupt swap, the reference
        # behavior — its RELOAD restarts the container, SURVEY.md §1 note).
        # The overlap-save tail is input-domain, so the old-spectrum output
        # is exactly reproducible with one extra dispatch; no recompile
        # (the spectrum is a traced argument).
        self._swap_fade_frames = swap_fade_frames
        self._fade_from: tuple | None = None
        # Output-sample position within an in-progress fade: the configured
        # fade length is honored even when one dispatch is shorter than the
        # window (low-latency mode dispatches a single block), by carrying
        # the ramp across process_block calls.
        self._fade_pos = 0
        # Serializes hot-swap (set_eq/load_filter/reset from a control
        # thread) against the streaming thread's process_block.
        self._lock = threading.Lock()
        # Device-PCM mode: process_block returns quantized int16 sample
        # values instead of float32 — on-device clamp/scale/[dither]/cast
        # halves the device->host transfer (ops/device_pcm.py rationale).
        self.device_pcm = device_pcm
        self._pcm_dither = bool(pcm_dither)
        self._pcm_seed = 0 if pcm_seed is None else pcm_seed
        self._pcm_counter = 0
        self._pcm_key = None
        # Host twin for the crossfade dispatches (which mix old/new filter
        # output in host float before quantizing).
        self._host_ditherer = None
        if device_pcm is not None and self._pcm_dither:
            from totton_tpu.io.pcm import TpdfDitherer

            self._host_ditherer = TpdfDitherer(self._pcm_seed)

    @classmethod
    def from_file(
        cls,
        json_path: str,
        channels: int = 2,
        eq_response: np.ndarray | None = None,
    ) -> "StreamingUpsampler":
        return cls(load_filter(json_path), channels, eq_response)

    # -- properties -------------------------------------------------------

    @property
    def channels(self) -> int:
        return self._channels

    @property
    def ratio(self) -> int:
        return self.config.ratio

    @property
    def block_input_frames(self) -> int:
        return self.config.block_in

    @property
    def filter(self) -> LoadedFilter:
        return self._filter

    # -- control ----------------------------------------------------------

    def reset(self) -> None:
        """Zero the carried history (reference Reset(),
        vulkan_streaming_upsampler.cpp:598-600)."""
        with self._lock:
            self._tail = jnp.zeros_like(self._tail)
            self._fade_from = None
            self._fade_pos = 0

    def _note_swap(self, old_spectrum: tuple) -> None:
        """Arm the crossfade (keep the ORIGINAL pre-swap spectrum if several
        swaps land during one fade — fade from what was last heard)."""
        if self._swap_fade_frames and self._fade_from is None:
            self._fade_from = old_spectrum
            self._fade_pos = 0

    def set_dither(self, enabled: bool) -> bool:
        """Swap output dithering live (device-PCM mode only; in float mode
        quantization — and thus dither — belongs to the sink). Mirrors
        AudioSink.set_dither so the CLI's RELOAD path can target whichever
        side owns the quantizer."""
        if self.device_pcm is None:
            return False
        with self._lock:
            self._pcm_dither = bool(enabled)
            if enabled and self._host_ditherer is None:
                from totton_tpu.io.pcm import TpdfDitherer

                self._host_ditherer = TpdfDitherer(self._pcm_seed)
        return True

    def _quantize_device(self, y):
        """Device-side s16 quantization of the step output (y still on
        device): the device->host transfer below moves int16, not float32."""
        from totton_tpu.ops import device_pcm as _dp

        if self._pcm_dither:
            import jax

            if self._pcm_key is None:
                self._pcm_key = jax.random.PRNGKey(self._pcm_seed)
            self._pcm_counter += 1
            return _dp.quantize_s16_dithered(
                y, self._pcm_key, jnp.uint32(self._pcm_counter))
        return _dp.quantize_s16(y)

    def set_eq(self, eq_response: np.ndarray | None) -> None:
        """Hot-swap the EQ baked into the filter spectrum.

        The spectrum is a traced argument of the jitted step, so this never
        triggers recompilation (live RELOAD support).
        """
        spectrum = filter_spectrum(
            self._filter.taps, self.config.fft_size, eq_response
        )
        with self._lock:
            self._note_swap(self._spectrum)
            self._spectrum = spectrum

    def load_filter(
        self, filt: LoadedFilter, eq_response: np.ndarray | None = None
    ) -> None:
        """Swap filters. Recompiles only if the overlap-save geometry differs."""
        cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
        spectrum = filter_spectrum(filt.taps, cfg.fft_size, eq_response)
        with self._lock:
            self._filter = filt
            if cfg != self.config:
                self.config = cfg
                self._step = make_block_step(cfg)
                self._tail = jnp.zeros((self._channels, cfg.halo_in),
                                       jnp.float32)
                # Geometry changed: old/new outputs have different shapes,
                # and history restarts anyway — no crossfade possible.
                self._fade_from = None
                self._fade_pos = 0
            else:
                self._note_swap(self._spectrum)
            self._spectrum = spectrum

    # -- processing -------------------------------------------------------
    #
    # Two-phase API: dispatch_block() submits one step to the device and
    # returns a handle WITHOUT waiting (the JAX backend dispatches
    # asynchronously; the carried tail is itself a device value, so
    # consecutive dispatches chain on-device with no host sync between
    # them); fetch() blocks for the device->host read. Stream sessions
    # exploit this to overlap step i+1's dispatch with step i's drain
    # (io/stream.py pipelining: don't host-block on the output before
    # feeding the next step). process_block() is the
    # synchronous composition and keeps the reference-parity surface.

    def dispatch_block(self, x: np.ndarray):
        """Submit [channels, k*block_in] input frames; returns an opaque
        handle for fetch(). Never blocks on device compute. Hot-swaps
        (set_eq / load_filter / reset) serialize against dispatch — a
        swap applies to every step dispatched after it; fades are
        bookkept here (dispatch order = output order)."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != self._channels:
            raise ValueError(
                f"expected [channels={self._channels}, n] input, got {x.shape}"
            )
        with self._lock:
            if x.shape[1] == 0 or x.shape[1] % self.config.block_in != 0:
                raise ValueError(
                    f"input length {x.shape[1]} must be a positive multiple "
                    f"of block_input_frames {self.config.block_in}"
                )
            tail_before = self._tail
            xj = jnp.asarray(x)
            y, self._tail = self._step(tail_before, xj, self._spectrum)
            fade = None
            if self._fade_from is not None:
                # One PARTIAL dispatch with the pre-swap spectrum (the
                # tail is input-domain — identical for both), then a
                # linear ramp old -> new over swap_fade_frames output
                # samples. The fade window covers only the first n output
                # samples of this dispatch, so only the ceil(n/block_size)
                # leading blocks are recomputed — not the whole dispatch
                # (a 1024-block offline dispatch would otherwise double
                # its cost for a ~4096-sample fade). The ramp starts at
                # exactly 0 (sample 0 is pure old filter) and is carried
                # across dispatches when one dispatch is shorter than the
                # configured window, so the full fade length is honored.
                total = self._swap_fade_frames
                k_blocks = x.shape[1] // self.config.block_in
                n = min(total - self._fade_pos,
                        k_blocks * self.config.block_size)
                # Power-of-two dispatch width keeps the fade-shape
                # universe logarithmic — see _fade_prefix.
                y_old, _ = self._step(
                    tail_before,
                    _fade_prefix(xj, n, self.config.block_size,
                                 self.config.block_in),
                    self._fade_from)
                ramp = (self._fade_pos
                        + np.arange(n, dtype=np.float32)) / total
                fade = (y_old, ramp, n)
                self._fade_pos += n
                if self._fade_pos >= total:
                    self._fade_from = None
                    self._fade_pos = 0
            if self.device_pcm is not None and fade is None:
                y = self._quantize_device(y)
        return (y, fade)

    def fetch(self, handle) -> np.ndarray:
        """Block for a dispatched step's output (device->host). Fetch in
        dispatch order: the host dither twin and fade ramps are stateful
        in that order."""
        y, fade = handle
        if fade is not None:
            y_old, ramp, n = fade
            y = np.array(y)  # writable host copy
            y[:, :n] = (np.asarray(y_old)[:, :n] * (1.0 - ramp)
                        + y[:, :n] * ramp)
            if self.device_pcm is not None:
                # Fade dispatches mix in host float; quantize with the
                # host twin so the output dtype contract holds.
                from totton_tpu.io.pcm import quantize_s16_host

                return quantize_s16_host(
                    y, self._host_ditherer if self._pcm_dither else None)
            return y
        return np.asarray(y)

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """Process [channels, k*block_in] input frames -> [channels, k*block_size].

        Accepts any whole number of blocks at once (the reference processes
        exactly one block per call); carried history updates automatically.
        """
        return self.fetch(self.dispatch_block(x))


def upsample_signal(
    x: np.ndarray,
    filt: LoadedFilter,
    eq_response: np.ndarray | None = None,
) -> np.ndarray:
    """Offline convenience: upsample [channels, n] (any n) in one batched call.

    Pads the tail block with zeros, then trims the output to n * ratio —
    matching the reference file pipeline's partial-last-block semantics
    (alsa_streamer_main.cpp:301-303).
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    channels, n = x.shape
    eng = StreamingUpsampler(filt, channels, eq_response)
    block_in = eng.config.block_in
    n_pad = (-n) % block_in
    if n_pad:
        x = np.pad(x, [(0, 0), (0, n_pad)])
    y = eng.process_block(x)
    return y[:, : n * eng.ratio]
