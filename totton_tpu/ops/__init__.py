"""Core device compute ops (JAX/XLA).

The hot path of the framework: overlap-save frequency-domain FIR convolution
with integer zero-stuff upsampling, batched over channels and time blocks.
Re-design of the reference engine
(src/vulkan/vulkan_streaming_upsampler.cpp).
"""

from totton_tpu.ops.overlap_save import (
    OverlapSaveConfig,
    filter_spectrum,
    frame_input,
    upsample_blocks,
    upsample_frames,
    make_block_step,
    zero_stuff,
)

__all__ = [
    "OverlapSaveConfig",
    "filter_spectrum",
    "frame_input",
    "upsample_blocks",
    "upsample_frames",
    "make_block_step",
    "zero_stuff",
]
