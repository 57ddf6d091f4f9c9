"""Host-side audio IO: PCM conversion, WAV/raw files, ring buffers, sources
and sinks, and the streaming session that feeds the device engine.

Replaces the reference's ALSA middleware (src/alsa/alsa_common.cpp,
src/io/) with a device-agnostic source/sink abstraction; ALSA hardware
itself is out of scope on accelerator hosts, but the negotiation, conversion, and
buffering semantics are preserved.
"""

from totton_tpu.io.pcm import (
    PcmFormat,
    parse_format,
    bytes_per_sample,
    pcm_to_float,
    float_to_pcm,
    TpdfDitherer,
    interleave,
    deinterleave,
)
from totton_tpu.io.formats import PcmFormatSet
from totton_tpu.io.ring_buffer import AudioRingBuffer
from totton_tpu.io.wav import read_wav, write_wav

__all__ = [
    "PcmFormat",
    "parse_format",
    "bytes_per_sample",
    "pcm_to_float",
    "float_to_pcm",
    "TpdfDitherer",
    "interleave",
    "deinterleave",
    "PcmFormatSet",
    "AudioRingBuffer",
    "read_wav",
    "write_wav",
]
