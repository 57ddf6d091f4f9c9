"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices. Tests marked
``gpu`` need a CUDA device: they skip here and run on the card from
``chip_smoke.py``.
"""

import os

# XLA reads this flag when the CPU client is created; set it before any
# backend initialization.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["TOTTON_PLATFORM"] = "cpu"  # inherited by CLI subprocess tests

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def coefficients_dir(tmp_path_factory):
    """Small but real filter artifacts shared across the test session.

    Uses reduced tap counts so design stays fast; geometry/semantics are
    identical to the production 80k-tap filters.
    """
    out = tmp_path_factory.mktemp("coefficients")
    from totton_tpu.filters.generate import generate_one

    for key, taps in [("44k_2x", 2000), ("44k_16x", 6000), ("48k_4x", 2000)]:
        generate_one(key, taps, 25.0, 140.0, "minimum", str(out))
    return out
