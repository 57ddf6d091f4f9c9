"""On-device float32 -> s16 PCM quantization.

Why this exists: the reference pipeline ships float32 off the device
(4 B/sample) only to truncate it to the sink's integer format on the host
(reference conversion: src/alsa/alsa_common.cpp:87-127). Quantizing to
int16 ON the device halves the device->host transfer bytes, which matters
where that link is slower than the device; the extra device pass is one
fused elementwise op (~6 B/sample of device memory traffic).

S16_LE is the only format offered here on purpose: s24/s32 transfer as
int32 (4 B/sample — no transfer win over float32), and their host paths
are bit-exact with the reference's C casts, so there is nothing to gain
and a float64 dither contract to lose. 16-bit is also where dither
actually matters.

Bit-compatibility contract (tested against io/pcm.float_to_pcm):
- undithered: clamp to [-1.0, 0.9999695], scale by 32768, truncate toward
  zero — XLA's float->int ConvertElementType truncates like the C cast.
- dithered: TPDF noise in [-1, 1) LSB + round-to-nearest
  (floor(v + n + 0.5)), the same quantizer as io/pcm.TpdfDitherer; the
  noise stream is jax.random (threefry) instead of the host path's
  PCG64 — both are white TPDF, reproducible from a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_CLAMP_LO = -1.0
_CLAMP_HI = 0.9999695  # PcmFormat.S16_LE.clamp_hi (alsa_common.cpp parity)
_SCALE = 32768.0


@jax.jit
def quantize_s16(y: jax.Array) -> jax.Array:
    """float32 [..., n] -> int16 [..., n]; truncation toward zero (the
    reference's undithered C-cast semantics)."""
    clamped = jnp.clip(y, _CLAMP_LO, _CLAMP_HI)
    return (clamped * _SCALE).astype(jnp.int16)


@jax.jit
def quantize_s16_dithered(y: jax.Array, key: jax.Array,
                          counter: jax.Array) -> jax.Array:
    """TPDF-dithered round-to-nearest s16 quantization on device.

    `key` is the stream's base PRNG key; `counter` a per-dispatch counter
    folded in so successive blocks draw fresh, reproducible noise without
    any device-resident RNG state (no extra dispatch for key splitting).
    """
    clamped = jnp.clip(y, _CLAMP_LO, _CLAMP_HI)
    scaled = clamped * _SCALE
    sub = jax.random.fold_in(key, counter)
    k1, k2 = jax.random.split(sub)
    noise = (jax.random.uniform(k1, y.shape)
             + jax.random.uniform(k2, y.shape) - 1.0)
    vals = jnp.floor(scaled + noise + 0.5)
    # floor(0.9999695*32768 + <1 + 0.5) can reach 32768: clamp at the
    # integer edge before the narrowing convert (host path parity:
    # io/pcm._pack_ints clips in int64).
    vals = jnp.clip(vals, -32768.0, 32767.0)
    return vals.astype(jnp.int16)
