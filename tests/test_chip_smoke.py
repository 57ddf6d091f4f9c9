"""The CPU-checkable parts of chip_smoke.py: its refusal to run without a
GPU, its float64 oracle and its SNR gate."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("ratio", [2, 16])
def test_oracle_is_zero_stuffed_convolution(smoke, rng, ratio):
    x = rng.normal(size=(2, 50))
    h = rng.normal(size=33)
    up = np.zeros((2, 50 * ratio))
    up[:, ::ratio] = x
    ref = np.stack([np.convolve(up[c], h)[: 50 * ratio] for c in range(2)])
    np.testing.assert_allclose(smoke.oracle(x, h, ratio), ref, atol=1e-9)


@pytest.mark.parametrize("mantissa_bits,passes", [
    (23, True),   # float32
    (10, False),  # TF32: ~60 dB
    (7, False),   # bfloat16
])
def test_gate_catches_reduced_precision(smoke, rng, mantissa_bits, passes):
    ref = rng.normal(size=100_000)
    y = ref.astype(np.float32)
    mask = np.uint32((0xFFFFFFFF << (23 - mantissa_bits)) & 0xFFFFFFFF)
    y = (y.view(np.uint32) & mask).view(np.float32)
    snr = smoke.snr_db(y, ref)
    if passes:
        smoke.gate("f32", snr)
    else:
        with pytest.raises(SystemExit, match="below"):
            smoke.gate("reduced", snr)
