"""Audio sources and sinks — the device layer.

The reference talks to ALSA hardware (src/alsa/, src/io/dac_capability.cpp);
on a GPU host the endpoints are files, pipes, sockets, or a null device.
This module gives them a uniform frame interface plus a capability
descriptor that plays the DAC-capability role in rate negotiation.

Registry names mirror the reference CLI conventions:
  "null"                    -> NullSource / NullSink (reference e2e tests
                               use the ALSA null device the same way)
  "file:<path>"             -> raw float/PCM file
  "wav:<path>"              -> WAV file
  "-"                       -> stdin/stdout raw PCM
  "tcp://host:port"         -> framed PCM stream socket, active connect
  "tcp-listen://[host]:port"-> same, bind + accept one peer
  "unix:/path"              -> unix-domain stream socket, connect
  "unix-listen:/path"       -> same, bind + accept one peer
(socket wire format: totton_tpu.io.sockets — the live-transport analog of
the reference's ALSA device loop for hosts where audio arrives over the
network)
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from totton_tpu.io.formats import PcmFormatSet
from totton_tpu.io.pcm import (
    PcmFormat,
    TpdfDitherer,
    deinterleave,
    float_to_pcm,
    interleave,
    pcm_to_float,
)
from totton_tpu.io.wav import read_wav


class SinkClosedError(Exception):
    """The output endpoint's peer is gone (e.g. a socket receiver exited).

    Sinks raise this from write_frames/write_quantized so stream sessions
    can treat a departed consumer as a CLEAN stop (drain, close, exit 0)
    instead of a crash — the sink-side analog of a source returning EOF.
    """


@dataclasses.dataclass(frozen=True)
class SinkCapability:
    """What an output endpoint supports (reference: DacCapability struct,
    include/io/dac_capability.h)."""

    min_rate: int = 8000
    max_rate: int = 1536000
    supported_rates: tuple[int, ...] = ()
    max_channels: int = 32
    name: str = ""

    def is_rate_supported(self, rate: int) -> bool:
        if self.supported_rates:
            return rate in self.supported_rates
        return self.min_rate <= rate <= self.max_rate

    @classmethod
    def unconstrained(cls, name: str = "file") -> "SinkCapability":
        return cls(name=name)


class AudioSource:
    """Pull interface: read_frames(n) -> float32 [channels, <=n] (short or
    empty at EOF)."""

    channels: int = 2
    sample_rate: int | None = None

    def read_frames(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        pass


class AudioSink:
    """Push interface: write_frames([channels, n])."""

    capability: SinkCapability = SinkCapability.unconstrained()

    def write_frames(self, x: np.ndarray) -> None:
        raise NotImplementedError

    def set_dither(self, enabled: bool) -> bool:
        """Swap the output-quantization ditherer live (True if this sink
        quantizes and took the change). Lets RELOAD re-read config's
        alsa.dither so the web settings toggle reaches the running engine
        without a restart."""
        if not hasattr(self, "_ditherer"):
            return False
        self._ditherer = TpdfDitherer() if enabled else None
        return True

    def write_quantized(self, x: np.ndarray) -> None:
        """Write already-quantized int16 sample values [channels, n]
        (engine device-PCM mode — quantization happened on the device;
        ops/device_pcm.py). Sinks with an s16 byte stream override this to
        pack directly; the fallback converts to the exact float32
        representation (int16 is exactly representable) and uses the
        normal path. Callers must open the sink UNdithered in this mode —
        the samples are final, re-dithering would double the noise."""
        self.write_frames(np.asarray(x, np.float32) * np.float32(1 / 32768.0))

    def close(self) -> None:
        pass


class NullSource(AudioSource):
    """Silence generator (the 'null' capture device)."""

    def __init__(self, channels: int = 2, sample_rate: int = 44100,
                 total_frames: int | None = None) -> None:
        self.channels = channels
        self.sample_rate = sample_rate
        self._remaining = total_frames

    def read_frames(self, n: int) -> np.ndarray:
        if self._remaining is not None:
            n = min(n, self._remaining)
            self._remaining -= n
        return np.zeros((self.channels, n), dtype=np.float32)


class NullSink(AudioSink):
    """Discards everything, counts frames (the 'null' playback device)."""

    def __init__(self) -> None:
        self.frames_written = 0
        self.capability = SinkCapability.unconstrained("null")

    def write_frames(self, x: np.ndarray) -> None:
        self.frames_written += np.atleast_2d(x).shape[1]

    def write_quantized(self, x: np.ndarray) -> None:
        self.frames_written += np.atleast_2d(x).shape[1]


class RawFileSource(AudioSource):
    """Interleaved raw PCM file (reference --in-file mode,
    alsa_streamer_main.cpp:254-346)."""

    def __init__(self, path: str, fmt: PcmFormat, channels: int,
                 sample_rate: int | None = None) -> None:
        self._f = open(path, "rb") if path != "-" else sys.stdin.buffer
        self._fmt = fmt
        self.channels = channels
        self.sample_rate = sample_rate
        # stdin is typically a live pipe (`arecord | totton-stream -`):
        # dispatch block-at-a-time instead of accumulating a deep batch.
        # Unlike realtime capture it still backpressures, never drops.
        self.low_latency = path == "-"

    def read_frames(self, n: int) -> np.ndarray:
        raw = self._f.read(n * self.channels * self._fmt.bytes)
        usable = len(raw) - len(raw) % (self.channels * self._fmt.bytes)
        if usable == 0:
            return np.zeros((self.channels, 0), dtype=np.float32)
        samples = pcm_to_float(raw[:usable], self._fmt)
        return deinterleave(samples, self.channels)

    def close(self) -> None:
        if self._f is not sys.stdin.buffer:
            self._f.close()


class RawFileSink(AudioSink):
    def __init__(self, path: str, fmt: PcmFormat,
                 ditherer: TpdfDitherer | None = None) -> None:
        self._f = open(path, "wb") if path != "-" else sys.stdout.buffer
        self._fmt = fmt
        self._ditherer = ditherer
        self.capability = SinkCapability.unconstrained("raw")

    def write_frames(self, x: np.ndarray) -> None:
        self._f.write(
            float_to_pcm(interleave(np.atleast_2d(x)), self._fmt,
                         self._ditherer)
        )

    def write_quantized(self, x: np.ndarray) -> None:
        if self._fmt is PcmFormat.S16_LE:
            # Device-quantized samples ARE the byte stream: interleave and
            # write, no host conversion pass at all.
            self._f.write(
                interleave(np.atleast_2d(x)).astype("<i2").tobytes())
            return
        super().write_quantized(x)

    def close(self) -> None:
        self._f.flush()
        if self._f is not sys.stdout.buffer:
            self._f.close()


class WavFileSource(AudioSource):
    def __init__(self, path: str) -> None:
        self._data, self.sample_rate = read_wav(path)
        self.channels = self._data.shape[0]
        self._pos = 0

    def read_frames(self, n: int) -> np.ndarray:
        out = self._data[:, self._pos : self._pos + n]
        self._pos += out.shape[1]
        return out


class WavFileSink(AudioSink):
    """Streams chunks into the WAV file as they arrive (the stdlib wave
    writer patches the length header on close). Quantization happens per
    chunk at write time — so a live dither toggle (set_dither via the
    RELOAD path) takes effect from that point of the stream on, matching
    the raw/socket sinks, and an hours-long stream never buffers in RAM."""

    def __init__(self, path: str, sample_rate: int,
                 fmt: PcmFormat = PcmFormat.S24_3LE,
                 ditherer: TpdfDitherer | None = None) -> None:
        self._path = path
        self._rate = sample_rate
        self._fmt = fmt
        self._ditherer = ditherer
        self._w = None
        self.capability = SinkCapability.unconstrained("wav")

    def _writer(self, channels: int):
        if self._w is None:
            import wave

            self._w = wave.open(self._path, "wb")
            self._w.setnchannels(channels)
            self._w.setsampwidth(self._fmt.bytes)
            self._w.setframerate(self._rate)
        return self._w

    def write_frames(self, x: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float32))
        self._writer(x.shape[0]).writeframes(
            float_to_pcm(interleave(x), self._fmt, self._ditherer))

    def write_quantized(self, x: np.ndarray) -> None:
        x = np.atleast_2d(x)
        if self._fmt is PcmFormat.S16_LE:
            self._writer(x.shape[0]).writeframes(
                interleave(x).astype("<i2").tobytes())
            return
        super().write_quantized(x)

    def close(self) -> None:
        # No audio written: still emit a valid (empty, stereo) WAV, the
        # historical contract of this sink.
        self._writer(2).close()
        self._w = None


class LoopbackPair:
    """In-memory source/sink pair for tests (plays the role of the
    reference's snd-aloop loopback, scripts/test/alsa_loopback_helper.py)."""

    def __init__(self, channels: int = 2, sample_rate: int = 44100) -> None:
        from totton_tpu.io.ring_buffer import AudioRingBuffer

        self._ring = AudioRingBuffer(1 << 20)
        self.channels = channels
        self.sample_rate = sample_rate

    def sink_write(self, x: np.ndarray) -> bool:
        return self._ring.write(interleave(np.atleast_2d(x)))

    def source_read(self, n: int) -> np.ndarray:
        got = self._ring.read(n * self.channels)
        if got is None:
            return np.zeros((self.channels, 0), np.float32)
        return deinterleave(got, self.channels)


def list_devices() -> dict:
    """Enumerate available endpoint kinds (the LIST_ALSA_DEVICES analog —
    reference: src/io/dac_capability.cpp:36-52)."""
    return {
        "playback": [
            {"id": "null", "name": "Null sink (discard)"},
            {"id": "file:<path>", "name": "Raw PCM file sink"},
            {"id": "wav:<path>", "name": "WAV file sink"},
            {"id": "-", "name": "stdout raw PCM"},
            {"id": "tcp://<host>:<port>", "name": "PCM stream socket (connect)"},
            {"id": "tcp-listen://[host]:<port>",
             "name": "PCM stream socket (listen)"},
            {"id": "unix:<path>", "name": "Unix-domain PCM stream (connect)"},
            {"id": "unix-listen:<path>",
             "name": "Unix-domain PCM stream (listen)"},
        ],
        "capture": [
            {"id": "null", "name": "Null source (silence)"},
            {"id": "file:<path>", "name": "Raw PCM file source"},
            {"id": "wav:<path>", "name": "WAV file source"},
            {"id": "-", "name": "stdin raw PCM"},
            {"id": "tcp://<host>:<port>", "name": "PCM stream socket (connect)"},
            {"id": "tcp-listen://[host]:<port>",
             "name": "PCM stream socket (listen)"},
            {"id": "unix:<path>", "name": "Unix-domain PCM stream (connect)"},
            {"id": "unix-listen:<path>",
             "name": "Unix-domain PCM stream (listen)"},
        ],
    }


def open_source(
    spec: str,
    fmt: PcmFormat | None = PcmFormat.S32_LE,
    channels: int = 2,
    sample_rate: int | None = None,
    socket_reconnect_s: float = 0.0,
) -> AudioSource:
    from totton_tpu.io.sockets import SocketSource, SocketSpec

    if SocketSpec.matches(spec):
        # format/channels/rate arrive in the stream header.
        return SocketSource(spec, reconnect_window_s=socket_reconnect_s)
    if fmt is None:
        raise ValueError(
            "float32 wire format is socket-only; pick s16/s24/s32 for "
            f"endpoint {spec!r}")
    if spec == "null":
        return NullSource(channels, sample_rate or 44100)
    if spec.startswith("wav:"):
        return WavFileSource(spec[4:])
    if spec.endswith(".wav"):
        return WavFileSource(spec)
    path = spec[5:] if spec.startswith("file:") else spec
    return RawFileSource(path, fmt, channels, sample_rate)


def open_sink(
    spec: str,
    sample_rate: int,
    fmt: PcmFormat | None = PcmFormat.S32_LE,
    dither: bool = False,
) -> AudioSink:
    from totton_tpu.io.sockets import SocketSink, SocketSpec

    ditherer = TpdfDitherer() if dither else None
    if SocketSpec.matches(spec):
        return SocketSink(spec, sample_rate, fmt, ditherer)
    if fmt is None:
        raise ValueError(
            "float32 wire format is socket-only; pick s16/s24/s32 for "
            f"endpoint {spec!r}")
    if spec == "null":
        return NullSink()
    if spec.startswith("wav:"):
        return WavFileSink(spec[4:], sample_rate, fmt, ditherer)
    if spec.endswith(".wav"):
        return WavFileSink(spec, sample_rate, fmt, ditherer)
    path = spec[5:] if spec.startswith("file:") else spec
    return RawFileSink(path, fmt, ditherer)
