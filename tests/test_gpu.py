"""Checks that need a CUDA GPU (marker ``gpu``).

They skip under the CPU test run; ``chip_smoke.py`` runs them on the card.
"""

import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COEF = os.path.join(ROOT, "data", "coefficients")

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; run on the card with chip_smoke.py")


def _production_step(ratio: int):
    from totton_tpu.filters.sidecar import load_filter
    from totton_tpu.ops.overlap_save import (
        OverlapSaveConfig,
        filter_spectrum,
        make_block_step,
    )

    filt = load_filter(
        os.path.join(COEF, f"filter_44k_{ratio}x_80000_min_phase.json"))
    cfg = OverlapSaveConfig.from_sidecar(filt.sidecar)
    return filt, cfg, make_block_step(cfg), filter_spectrum(filt.taps,
                                                            cfg.fft_size)


def test_step_compiles_to_library_fft_without_matmuls():
    """On the card the transform is XLA's FFT (cuFFT), not a DFT matmul."""
    import jax.numpy as jnp

    _, cfg, step, spec = _production_step(16)
    tail = jnp.zeros((2, cfg.halo_in), jnp.float32)
    x = jnp.zeros((2, 4 * cfg.block_in), jnp.float32)
    hlo = step.lower(tail, x, spec).compile().as_text()
    assert " fft(" in hlo, "no FFT instruction in the compiled step"
    assert " dot(" not in hlo and "cublas" not in hlo, "matmul in the step"


def test_ratios_4_and_8_meet_the_gate_at_production_width():
    """The 4x and 8x banks (80001 taps, fft 131072), 32 blocks, against
    the float64 oracle at the 125 dB gate."""
    from scipy import signal as ssig

    rng = np.random.default_rng(6)
    for ratio in (4, 8):
        filt, cfg, step, spec = _production_step(ratio)
        x = (rng.normal(size=(2, 32 * cfg.block_in)) * 0.3).astype(np.float32)
        tail = np.zeros((2, cfg.halo_in), np.float32)
        y = np.asarray(step(tail, x, spec)[0], np.float64)
        up = np.zeros((2, x.shape[1] * ratio))
        up[:, ::ratio] = x
        ref = ssig.oaconvolve(up, np.asarray(filt.taps, np.float64)[None],
                              axes=-1)[:, : up.shape[1]]
        snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((y - ref) ** 2))
        assert snr >= 125.0, (ratio, snr)
