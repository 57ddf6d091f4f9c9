"""Streaming upsampler engine.

The equivalent of the reference's VulkanStreamingUpsampler
(src/vulkan/vulkan_streaming_upsampler.cpp) plus filter selection
(src/alsa/alsa_filter_selector.cpp).
"""

from totton_tpu.engine.upsampler import StreamingUpsampler, upsample_signal
from totton_tpu.engine.selector import resolve_filter_path

__all__ = ["StreamingUpsampler", "upsample_signal", "resolve_filter_path"]
