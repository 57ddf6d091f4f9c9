"""Overlap-save frequency-domain FIR upsampling — the framework's hot path.

Re-design of the reference engine's ProcessBlock
(src/vulkan/vulkan_streaming_upsampler.cpp:500-596). The reference runs, per
block and per channel: full-size complex FFT of the zero-stuffed signal on
GPU, a *CPU-side* pointwise multiply in mapped memory, and a full-size
inverse FFT. This implementation differs structurally:

1. **Zero-stuffing is free.** The DFT of a zero-stuffed signal is the
   periodic extension of the compact signal's DFT:
       u[n] = x[n/r] if r | n else 0   =>   U[k] = X[k mod M],  N = r*M.
   So the forward transform is an rfft of length fft_size/ratio on the
   *input-rate* frame (16x smaller at ratio 16) plus an O(N) copy —
   never materializing the zero-stuffed signal.

2. **No sequential state.** Overlap-save needs only the previous taps-1
   *input* samples (a halo), not carried output state. All blocks compute in
   parallel: batched [channels, blocks, frame] rffts -> spectral multiply ->
   batched irffts. Streaming mode just carries the last halo_in input
   samples; time-sharding across devices exchanges the same halo via
   jax.lax.ppermute (see totton_tpu.parallel).

3. **The spectral multiply stays on the device**, fused by XLA between the
   two library transforms — fixing the reference's GPU->CPU->GPU round trip.

Per frame the pipeline is: ``jnp.fft.rfft`` of the input-rate frame
(complex64), periodic extension to the output-rate bin grid, multiply by
the filter spectrum, ``jnp.fft.irfft`` at fft_size, discard the first
taps-1 samples. On a GPU XLA lowers both transforms to cuFFT; the same
code runs on the CPU backend for tests. The filter spectrum is
precomputed in float64 on host and cast once; the runtime signal path is
float32 like the reference (src/vulkan/fft_utils.h:30). Spectra cross
the engine, serve and sharded boundaries as (re, im) float32 pairs and are
joined with ``lax.complex`` inside the jitted step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class OverlapSaveConfig:
    """Static geometry of one overlap-save convolver.

    Invariants mirror the sidecar contract (docs/filter_format.md):
    fft_size power of two, fft_size - block_size == taps - 1,
    block_size % ratio == 0, and (taps - 1) % ratio == 0.
    """

    taps: int
    fft_size: int
    block_size: int
    ratio: int

    def __post_init__(self) -> None:
        if self.fft_size & (self.fft_size - 1):
            raise ValueError(f"fft_size must be a power of two: {self.fft_size}")
        if self.fft_size - self.block_size != self.taps - 1:
            raise ValueError(
                f"overlap-save invariant violated: {self.fft_size} - "
                f"{self.block_size} != {self.taps} - 1"
            )
        if self.ratio < 1 or (self.ratio & (self.ratio - 1)):
            raise ValueError(f"ratio must be a power of two >= 1: {self.ratio}")
        if self.block_size % self.ratio != 0:
            raise ValueError("block_size must be divisible by ratio")
        if (self.taps - 1) % self.ratio != 0:
            raise ValueError("(taps - 1) must be divisible by ratio")
        if self.ratio > 1 and (self.fft_size // self.ratio) % 2 != 0:
            raise ValueError("fft_size / ratio must be even")

    @classmethod
    def from_sidecar(cls, sidecar) -> "OverlapSaveConfig":
        return cls(
            taps=sidecar.taps,
            fft_size=sidecar.fft_size,
            block_size=sidecar.block_size,
            ratio=sidecar.upsample_factor,
        )

    @property
    def overlap(self) -> int:
        """History carried between blocks, in output-rate samples."""
        return self.taps - 1

    @property
    def frame_in(self) -> int:
        """Input-rate samples entering each FFT frame (= fft_size / ratio)."""
        return self.fft_size // self.ratio

    @property
    def block_in(self) -> int:
        """Fresh input-rate samples consumed per block."""
        return self.block_size // self.ratio

    @property
    def halo_in(self) -> int:
        """Input-rate history samples each block needs (= (taps-1) / ratio)."""
        return (self.taps - 1) // self.ratio

    @property
    def n_bins(self) -> int:
        """rfft bins at the output rate."""
        return self.fft_size // 2 + 1


def filter_spectrum(
    taps: np.ndarray,
    fft_size: int,
    eq_response: np.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Precompute the filter's rfft spectrum, optionally with EQ baked in.

    Computed in float64 on host (numpy) and cast to a float32 pair once — the
    runtime FFT noise floor then dominates, not the spectrum precompute
    (the reference computes this in float32 via its CPU FFT,
    vulkan_streaming_upsampler.cpp:726-753; float64 here is strictly better).

    ``eq_response`` is a real magnitude or complex response sampled on the
    same rfft bin grid (len fft_size//2 + 1) at the output rate — the
    "EQ baked into the filter spectrum" path (reference:
    include/audio/eq_to_fir.h:34-37).
    """
    h = np.asarray(taps, dtype=np.float64)
    if len(h) > fft_size:
        raise ValueError(f"taps ({len(h)}) longer than fft_size ({fft_size})")
    spectrum = np.fft.rfft(h, fft_size)
    if eq_response is not None:
        eq_response = np.asarray(eq_response)
        if eq_response.shape != spectrum.shape:
            raise ValueError(
                f"eq_response shape {eq_response.shape} != rfft bins "
                f"{spectrum.shape}"
            )
        spectrum = spectrum * eq_response
    return (
        jnp.asarray(spectrum.real.astype(np.float32)),
        jnp.asarray(spectrum.imag.astype(np.float32)),
    )


def zero_stuff(x: jnp.ndarray, ratio: int) -> jnp.ndarray:
    """Insert ratio-1 zeros after each sample along the last axis.

    Reference semantics (vulkan_streaming_upsampler.cpp:532-534): sample i
    lands at position i*ratio. Used by tests/oracles; the hot path never
    materializes this (see module docstring).
    """
    if ratio == 1:
        return x
    shape = x.shape[:-1] + (x.shape[-1], ratio)
    out = jnp.zeros(shape, dtype=x.dtype)
    out = out.at[..., 0].set(x)
    return out.reshape(x.shape[:-1] + (x.shape[-1] * ratio,))


def frame_input(x: jnp.ndarray, block_in: int, halo_in: int) -> jnp.ndarray:
    """Frame [..., halo_in + B*block_in] -> [..., B, halo_in + block_in].

    frames[i] = x[i*block_in : i*block_in + halo_in + block_in] — overlapping
    windows built from K+1 shifted contiguous slices of a reshape (no gather),
    where K = ceil(halo_in / block_in). XLA-friendly: static shapes, slices,
    one concat.
    """
    n = x.shape[-1]
    if (n - halo_in) % block_in != 0:
        raise ValueError(
            f"input length {n} minus halo {halo_in} must be a multiple of "
            f"block_in {block_in}"
        )
    num_blocks = (n - halo_in) // block_in
    k = -(-halo_in // block_in)  # ceil
    pad = k * block_in - halo_in
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, 0)])
    blocks = xp.reshape(x.shape[:-1] + (k + num_blocks, block_in))
    wide = jnp.concatenate(
        [blocks[..., i : i + num_blocks, :] for i in range(k + 1)], axis=-1
    )
    return wide[..., pad:]


def _periodic_rfft_extend(xf: jnp.ndarray, ratio: int) -> jnp.ndarray:
    """Extend rfft(frame, M) to the rfft grid of the zero-stuffed length r*M.

    U[k] = X[k mod M] for k in [0, r*M/2]; the full period of X is rebuilt
    from the rfft half via Hermitian symmetry (X[M-k] = conj X[k]).
    """
    if ratio == 1:
        return xf
    batch = (1,) * (xf.ndim - 1)
    full = jnp.concatenate([xf[..., :-1], jnp.conj(xf[..., -1:0:-1])], axis=-1)
    return jnp.concatenate(
        [jnp.tile(full, batch + (ratio // 2,)), xf[..., :1]], axis=-1)


def upsample_frames(
    frames: jnp.ndarray, spectrum, cfg: OverlapSaveConfig
) -> jnp.ndarray:
    """[..., frame_in] input-rate frames -> [..., block_size] output blocks.

    rfft at the input rate -> periodic extension (the zero-stuffed
    spectrum) -> x H -> irfft at fft_size -> discard the first taps-1
    samples (overlap-save). ``spectrum`` is the (re, im) float32 pair of
    filter_spectrum.
    """
    hr, hi = spectrum
    h = jax.lax.complex(hr, hi)
    xf = jnp.fft.rfft(frames.astype(jnp.float32), n=cfg.frame_in)
    y = jnp.fft.irfft(_periodic_rfft_extend(xf, cfg.ratio) * h,
                      n=cfg.fft_size)
    return y[..., cfg.overlap :]


def upsample_blocks(
    x: jnp.ndarray, spectrum, cfg: OverlapSaveConfig
) -> jnp.ndarray:
    """Upsample a contiguous input carrying its own history.

    x: [..., halo_in + B*block_in] float32 at the input rate; the first
    halo_in samples are history (zeros at stream start).
    Returns [..., B*block_size] float32 at the output rate.
    """
    frames = frame_input(x, cfg.block_in, cfg.halo_in)
    blocks = upsample_frames(frames, spectrum, cfg)
    return blocks.reshape(x.shape[:-1] + (blocks.shape[-2] * cfg.block_size,))


@functools.lru_cache(maxsize=64)
def make_block_step(cfg: OverlapSaveConfig):
    """Jitted streaming step: (tail, x, spectrum) -> (y, new_tail).

    tail: [C, halo_in] carried input history; x: [C, B*block_in] fresh input;
    returns y: [C, B*block_size] and the updated tail. The spectrum is a
    traced argument, so filter hot-swap (RELOAD) never recompiles.
    """

    @jax.jit
    def step(tail: jnp.ndarray, x: jnp.ndarray, spectrum):
        xin = jnp.concatenate([tail, x], axis=-1)
        y = upsample_blocks(xin, spectrum, cfg)
        new_tail = xin[..., -cfg.halo_in :] if cfg.halo_in else tail[..., :0]
        return y, new_tail

    return step
