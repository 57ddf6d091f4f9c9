"""totton-tpu: an accelerator audio upsampling DSP framework on JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
Vulkan/VkFFT GPU upsampler (michihitoTakami/totton-rasp-gpu-dsp):

- 80k-tap minimum-phase FIR convolution upsampling (2x/4x/8x/16x, 44.1k/48k
  rate families) as overlap-save frequency-domain convolution
  (reference engine: src/vulkan/vulkan_streaming_upsampler.cpp).
- Equalizer-APO-style parametric EQ baked into the filter spectrum or run as
  cascaded biquads (reference: src/audio/eq_parser.cpp, eq_to_fir.cpp).
- Host-side streaming layer replacing the ALSA capture/playback loop
  (reference: src/alsa/).
- Kaiser-window filter design toolkit with the same .bin+.json sidecar format
  (reference: scripts/filters/, docs/filter_format.md).
- ZMQ control plane + web UI (reference: src/zmq/, web/).
- NEW vs the reference: multi-device / multi-host execution — channels and
  time-blocks sharded over a jax.sharding.Mesh with overlap-save halo exchange
  via jax.lax.ppermute.
"""

__version__ = "0.1.0"

import os as _os

if _os.environ.get("TOTTON_PLATFORM"):
    # Explicit platform choice (e.g. TOTTON_PLATFORM=cpu for tests and for
    # the control/web processes, which must not claim the GPU). Must run
    # before any JAX backend initialization.
    import jax as _jax

    _jax.config.update("jax_platforms", _os.environ["TOTTON_PLATFORM"])

#: Default persistent compile cache: a fixed directory at the checkout's
#: root (listed in .gitignore). A fixed path matters: the cache key
#: includes it, so a directory that moves never hits.
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=_os.environ) -> str | None:
    """The persistent XLA compilation cache directory for this process.

    JAX_COMPILATION_CACHE_DIR, when set, wins and nothing else is set in
    code; otherwise DEFAULT_COMPILE_CACHE. TOTTON_COMPILE_CACHE=0 (or
    off/false) turns the default off. Returns None when this package
    should set no cache directory.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    if environ.get("TOTTON_COMPILE_CACHE", "1").lower() in ("0", "off",
                                                           "false"):
        return None
    return DEFAULT_COMPILE_CACHE


def _enable_persistent_compile_cache() -> None:
    """Point JAX at compile_cache_dir() unless the caller already did.

    Set via env (not jax.config) when jax is not imported yet, so importing
    totton_tpu stays jax-import-free for control/web-only processes.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # jax reads it itself
    path = compile_cache_dir()
    if path is None:
        return
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError:
        return
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    import sys as _sys

    if "jax" in _sys.modules:
        # jax reads the env var at import; a process that imported jax
        # first (a test harness, an embedding application) needs the
        # config API instead.
        import jax as _jax

        _jax.config.update("jax_compilation_cache_dir", path)


_enable_persistent_compile_cache()
