"""Crossfeed engine: 2x2 matrix FIR convolution for headphone
speaker-simulation.

Consumes the 4-channel sets written by totton_tpu.filters.hrtf
(LL, LR, RL, RR — speaker -> ear impulse responses) and applies

    out_L = LL * in_L + RL * in_R
    out_R = LR * in_L + RR * in_R

as frequency-domain overlap-save at ratio 1, sharing one forward transform
per input channel (the reference only *generates* these filters; the
engine-side application is new here).
"""

from __future__ import annotations

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from totton_tpu.ops.overlap_save import OverlapSaveConfig, frame_input


class CrossfeedFilter:
    """4-channel crossfeed set loaded from the .bin + .json sidecar."""

    def __init__(self, channels: np.ndarray, meta: dict) -> None:
        if channels.ndim != 2 or channels.shape[0] != 4:
            raise ValueError(f"expected [4, taps] channels, got {channels.shape}")
        self.channels = channels.astype(np.float64)
        self.meta = meta
        self.taps = channels.shape[1]

    @classmethod
    def load(cls, json_path: str | os.PathLike) -> "CrossfeedFilter":
        json_path = os.fspath(json_path)
        meta = json.loads(open(json_path).read())
        bin_path = meta["coefficients_bin"]
        if not os.path.isabs(bin_path):
            bin_path = os.path.join(os.path.dirname(json_path), bin_path)
        n = int(meta["taps_per_channel"])
        data = np.fromfile(bin_path, dtype="<f4")
        if data.size != 4 * n:
            raise ValueError(
                f"bin size {data.size} != 4 * taps_per_channel {n}"
            )
        return cls(data.reshape(4, n), meta)


def _cf_geometry(taps: int) -> OverlapSaveConfig:
    # Pad taps to odd (even overlap not required at ratio 1, but keep the
    # sidecar invariant fft - block == taps - 1 with a healthy block).
    fft_size = 1 << max(10, math.ceil(math.log2(4 * taps)))
    return OverlapSaveConfig(
        taps=taps, fft_size=fft_size, block_size=fft_size - (taps - 1),
        ratio=1,
    )


@functools.lru_cache(maxsize=16)
def _make_cf_step(cfg: OverlapSaveConfig):
    @jax.jit
    def step(tail, x, h):  # x: [2, T]; h: [4, bins] complex64
        xin = jnp.concatenate([tail, x], axis=-1)
        frames = frame_input(xin, cfg.block_in, cfg.halo_in)  # [2, B, F]
        xf = jnp.fft.rfft(frames, n=cfg.frame_in)  # [2, B, bins]
        # out_L = LL*L + RL*R ; out_R = LR*L + RR*R  (indices 0..3 =
        # LL, LR, RL, RR).
        yf = jnp.stack([xf[0] * h[0] + xf[1] * h[2],
                        xf[0] * h[1] + xf[1] * h[3]])  # [2, B, bins]
        y = jnp.fft.irfft(yf, n=cfg.fft_size)[..., cfg.overlap:]
        out = y.reshape(2, -1)
        new_tail = xin[:, -cfg.halo_in:] if cfg.halo_in else tail[:, :0]
        return out, new_tail

    return step


class CrossfeedProcessor:
    """Stateful stereo crossfeed convolver (block streaming)."""

    def __init__(self, filt: CrossfeedFilter) -> None:
        self.filter = filt
        self.config = _cf_geometry(filt.taps)
        spectra = np.fft.rfft(filt.channels, self.config.fft_size)
        self._h = jnp.asarray(spectra.astype(np.complex64))
        self._step = _make_cf_step(self.config)
        self._tail = jnp.zeros((2, self.config.halo_in), jnp.float32)

    @property
    def block_input_frames(self) -> int:
        return self.config.block_in

    def reset(self) -> None:
        self._tail = jnp.zeros_like(self._tail)

    def process_block(self, x: np.ndarray) -> np.ndarray:
        """[2, k*block_in] stereo in -> [2, k*block_in] crossfed out."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[0] != 2:
            raise ValueError(f"crossfeed is stereo-only, got {x.shape}")
        if x.shape[1] == 0 or x.shape[1] % self.config.block_in != 0:
            raise ValueError(
                f"input length {x.shape[1]} must be a positive multiple of "
                f"{self.config.block_in}"
            )
        y, self._tail = self._step(self._tail, jnp.asarray(x), self._h)
        return np.asarray(y)


def crossfeed_signal(x: np.ndarray, filt: CrossfeedFilter) -> np.ndarray:
    """Offline convenience: crossfeed [2, n] (any n)."""
    x = np.asarray(x, dtype=np.float32)
    proc = CrossfeedProcessor(filt)
    n = x.shape[1]
    pad = (-n) % proc.config.block_in
    if pad:
        x = np.pad(x, [(0, 0), (0, pad)])
    return proc.process_block(x)[:, :n]
