"""Time-domain cascaded-biquad EQ kernel (alternate application path).

The primary EQ path bakes the response into the convolution filter spectrum
(zero runtime cost). This kernel exists for chains with no convolution stage
(e.g. EQ-only passthrough at ratio 1): a cascade of transposed-direct-form-II
biquads evaluated with jax.lax.scan over time, vmapped over channels, with
carried per-band state for streaming.

IIR recursions are inherently sequential; on the device this runs as a
scan. For S bands the per-sample work is a length-S fori cascade — fine for
audio EQ (S <= ~20). Throughput-critical EQ should use the spectral path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from totton_tpu.eq.apo import EqProfile
from totton_tpu.eq.biquad import biquad_coeffs


def profile_to_coeff_matrix(
    profile: EqProfile, sample_rate: float
) -> tuple[np.ndarray, float]:
    """(S, 5) float32 matrix of [b0, b1, b2, a1, a2] rows for the enabled,
    non-identity bands, plus the linear preamp gain."""
    rows = []
    for band in profile.bands:
        c = biquad_coeffs(band, sample_rate)
        if not c.is_identity:
            rows.append([c.b0, c.b1, c.b2, c.a1, c.a2])
    if not rows:
        rows = [[1.0, 0.0, 0.0, 0.0, 0.0]]
    preamp = 10.0 ** (profile.preamp_db / 20.0)
    return np.asarray(rows, dtype=np.float32), float(preamp)


@functools.partial(jax.jit, static_argnames=())
def _cascade_scan(x, coeffs, state, preamp):
    """x: [C, T]; coeffs: [S, 5]; state: [C, S, 2] TDF2 state; preamp scalar."""

    def per_channel(x_ch, state_ch):
        def step(carry, x_t):
            st = carry  # [S, 2]

            def band_body(i, acc):
                y_prev, st_acc = acc
                b0, b1, b2, a1, a2 = (
                    coeffs[i, 0], coeffs[i, 1], coeffs[i, 2],
                    coeffs[i, 3], coeffs[i, 4],
                )
                s1 = st_acc[i, 0]
                s2 = st_acc[i, 1]
                y = b0 * y_prev + s1
                s1_new = b1 * y_prev - a1 * y + s2
                s2_new = b2 * y_prev - a2 * y
                st_acc = st_acc.at[i, 0].set(s1_new).at[i, 1].set(s2_new)
                return y, st_acc

            y, st_new = jax.lax.fori_loop(
                0, coeffs.shape[0], band_body, (x_t * preamp, st)
            )
            return st_new, y

        final_state, y = jax.lax.scan(step, state_ch, x_ch)
        return y, final_state

    y, new_state = jax.vmap(per_channel)(x, state)
    return y, new_state


class BiquadCascade:
    """Stateful streaming cascade for a fixed profile and channel count."""

    def __init__(self, profile: EqProfile, sample_rate: float, channels: int):
        coeffs, preamp = profile_to_coeff_matrix(profile, sample_rate)
        self._coeffs = jnp.asarray(coeffs)
        self._preamp = jnp.float32(preamp)
        self._state = jnp.zeros((channels, coeffs.shape[0], 2), jnp.float32)

    def process(self, x: np.ndarray) -> np.ndarray:
        """x: [channels, n] float32 -> filtered [channels, n]."""
        y, self._state = _cascade_scan(
            jnp.asarray(x, dtype=jnp.float32), self._coeffs, self._state,
            self._preamp,
        )
        return np.asarray(y)

    def reset(self) -> None:
        self._state = jnp.zeros_like(self._state)


def make_cascade_step(profile: EqProfile, sample_rate: float, channels: int):
    """Functional streaming step: returns (step_fn, initial_state) where
    step_fn(x[C,T], state) -> (y[C,T], new_state)."""
    coeffs, preamp = profile_to_coeff_matrix(profile, sample_rate)
    coeffs_j = jnp.asarray(coeffs)
    preamp_j = jnp.float32(preamp)
    state0 = jnp.zeros((channels, coeffs.shape[0], 2), jnp.float32)

    def step(x, state):
        return _cascade_scan(x, coeffs_j, state, preamp_j)

    return step, state0


def biquad_cascade(
    x: np.ndarray, profile: EqProfile, sample_rate: float
) -> np.ndarray:
    """One-shot convenience: filter [channels, n] through the profile."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float32))
    cascade = BiquadCascade(profile, sample_rate, x.shape[0])
    return cascade.process(x)
