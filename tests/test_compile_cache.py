"""Where the persistent XLA compile cache lives."""

import os
import subprocess
import sys

import pytest

import totton_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_is_fixed_dir_at_checkout_root():
    assert totton_tpu.DEFAULT_COMPILE_CACHE == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("environ,expected", [
    ({}, "default"),
    ({"TOTTON_COMPILE_CACHE": "1"}, "default"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "/elsewhere"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere",
      "TOTTON_COMPILE_CACHE": "0"}, "/elsewhere"),
    ({"TOTTON_COMPILE_CACHE": "0"}, None),
    ({"TOTTON_COMPILE_CACHE": "off"}, None),
    ({"TOTTON_COMPILE_CACHE": "False"}, None),
])
def test_compile_cache_dir(environ, expected):
    if expected == "default":
        expected = totton_tpu.DEFAULT_COMPILE_CACHE
    assert totton_tpu.compile_cache_dir(environ) == expected


def test_import_points_jax_at_the_cache(tmp_path):
    """A fresh process that imports the package gets the resolved
    directory in jax's config; an explicit JAX_COMPILATION_CACHE_DIR is
    left exactly as given."""
    code = ("import totton_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "TOTTON_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == totton_tpu.DEFAULT_COMPILE_CACHE
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(tmp_path)
