"""FIR upsampling filter design: Kaiser lowpass + homomorphic minimum phase.

Behavioral parity with the reference's offline toolkit
(scripts/filters/generate_filter.py:26-35,447-519 and
scripts/filters/generate_minimum_phase.py:40-130), re-implemented from the
standard DSP algorithms:

- Kaiser-window lowpass at cutoff = (passband + stopband)/2 of the *output*
  rate, odd tap count.
- Minimum-phase conversion via the real-cepstrum (homomorphic) method with
  n_fft = 2^ceil(log2(8 * taps)); the conversion yields (n+1)//2 meaningful
  taps which are zero-padded back to the aligned tap count.
- Tap alignment: (taps - 1) % ratio == 0 (required by overlap-save geometry).
- DC-gain normalization to ratio * 0.99 (zero-stuff upsampling attenuates by
  1/ratio; the filter's DC gain restores amplitude, with 1% headroom).

All design math runs in float64 on host (numpy/scipy); only the exported taps
are float32. Accelerator float64 is slow, so design stays host-side.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import signal as _signal

# The eight production configs: 44.1k and 48k rate families, each a ladder of
# ratios whose input rate is the previous rung's output, so output is always
# 705.6 kHz / 768 kHz (reference: generate_filter.py:26-35).
MULTI_RATE_SPECS: dict[str, dict] = {
    "44k_16x": {"input_rate": 44100, "ratio": 16, "stopband": 22050},
    "44k_8x": {"input_rate": 88200, "ratio": 8, "stopband": 44100},
    "44k_4x": {"input_rate": 176400, "ratio": 4, "stopband": 88200},
    "44k_2x": {"input_rate": 352800, "ratio": 2, "stopband": 176400},
    "48k_16x": {"input_rate": 48000, "ratio": 16, "stopband": 24000},
    "48k_8x": {"input_rate": 96000, "ratio": 8, "stopband": 48000},
    "48k_4x": {"input_rate": 192000, "ratio": 4, "stopband": 96000},
    "48k_2x": {"input_rate": 384000, "ratio": 2, "stopband": 192000},
}

#: DC gain is normalized to ratio * this factor, leaving 1% headroom.
DC_GAIN_HEADROOM = 0.99

SUPPORTED_RATIOS = (1, 2, 4, 8, 16)


def aligned_tap_count(n_taps: int, ratio: int) -> int:
    """Smallest tap count >= n_taps with (taps - 1) % ratio == 0.

    Overlap-save with zero-stuff upsampling requires the overlap (taps - 1)
    to be a whole number of input samples at the output rate.
    """
    if n_taps < 1:
        raise ValueError(f"n_taps must be >= 1, got {n_taps}")
    if ratio < 1:
        raise ValueError(f"ratio must be >= 1, got {ratio}")
    rem = (n_taps - 1) % ratio
    return n_taps if rem == 0 else n_taps + (ratio - rem)


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Design-time specification of one upsampling filter.

    Invariants (mirroring the reference FilterConfig checks,
    generate_filter.py:55-89):
      - ratio in {1, 2, 4, 8, 16}
      - passband_end <= input Nyquist
      - passband_end < stopband_start
      - stopband_start <= output Nyquist
    """

    n_taps: int
    input_rate: int
    upsample_ratio: int
    stopband_start_hz: float
    passband_end_hz: float = 20000.0
    stopband_attenuation_db: float = 140.0
    kaiser_beta: float = 25.0
    phase: str = "minimum"  # "minimum" | "linear"

    def __post_init__(self) -> None:
        if self.upsample_ratio not in SUPPORTED_RATIOS:
            raise ValueError(
                f"upsample_ratio must be one of {SUPPORTED_RATIOS}, "
                f"got {self.upsample_ratio}"
            )
        if self.n_taps < 3:
            raise ValueError(f"n_taps too small: {self.n_taps}")
        if self.input_rate <= 0:
            raise ValueError(f"input_rate must be positive: {self.input_rate}")
        if self.passband_end_hz > self.input_rate / 2:
            raise ValueError(
                f"passband_end ({self.passband_end_hz} Hz) exceeds input "
                f"Nyquist ({self.input_rate / 2} Hz)"
            )
        if self.passband_end_hz >= self.stopband_start_hz:
            raise ValueError(
                f"passband_end ({self.passband_end_hz}) must be below "
                f"stopband_start ({self.stopband_start_hz})"
            )
        if self.stopband_start_hz > self.output_rate / 2:
            raise ValueError(
                f"stopband_start ({self.stopband_start_hz} Hz) exceeds output "
                f"Nyquist ({self.output_rate / 2} Hz)"
            )
        if self.phase not in ("minimum", "linear"):
            raise ValueError(f"phase must be 'minimum' or 'linear': {self.phase}")

    @property
    def output_rate(self) -> int:
        return self.input_rate * self.upsample_ratio

    @property
    def aligned_taps(self) -> int:
        return aligned_tap_count(self.n_taps, self.upsample_ratio)

    @property
    def target_dc_gain(self) -> float:
        """Zero-stuffing attenuates by 1/ratio; the filter's DC gain compensates."""
        return float(self.upsample_ratio)

    @property
    def cutoff_hz(self) -> float:
        return (self.passband_end_hz + self.stopband_start_hz) / 2.0

    @property
    def family(self) -> str:
        return "44k" if self.input_rate % 44100 == 0 else "48k"

    def basename(self, n_taps_label: int | None = None) -> str:
        """Artifact base name, matching the reference naming convention
        filter_{44k|48k}_{R}x_{taps}_{min|linear}_phase
        (reference: src/alsa/alsa_filter_selector.cpp:8-108)."""
        label = self.n_taps if n_taps_label is None else n_taps_label
        phase = "min" if self.phase == "minimum" else "linear"
        return f"filter_{self.family}_{self.upsample_ratio}x_{label}_{phase}_phase"

    @classmethod
    def from_multi_rate(cls, key: str, n_taps: int = 80000, **overrides) -> "FilterSpec":
        cfg = MULTI_RATE_SPECS[key]
        kwargs = dict(
            n_taps=n_taps,
            input_rate=cfg["input_rate"],
            upsample_ratio=cfg["ratio"],
            stopband_start_hz=float(cfg["stopband"]),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


def design_kaiser_lowpass(spec: FilterSpec) -> np.ndarray:
    """Linear-phase Kaiser-window lowpass prototype (float64, odd taps).

    Cutoff at the transition-band midpoint of the *output* rate
    (reference: generate_minimum_phase.py:44-61).
    """
    numtaps = spec.aligned_taps
    if numtaps % 2 == 0:
        numtaps += 1  # firwin needs odd taps for a type-I lowpass
    normalized_cutoff = spec.cutoff_hz / (spec.output_rate / 2.0)
    return _signal.firwin(
        numtaps=numtaps,
        cutoff=normalized_cutoff,
        window=("kaiser", spec.kaiser_beta),
        fs=2.0,
        scale=True,
    ).astype(np.float64)


def minimum_phase_homomorphic(
    h: np.ndarray, n_fft: int | None = None, n_out: int | None = None
) -> np.ndarray:
    """Real-cepstrum (homomorphic) minimum-phase conversion.

    Standard algorithm: fold the anti-causal half of the real cepstrum of
    log|H| onto the causal half, exponentiate back. Preserves |H|.

    Returns ``n_out`` taps (default: len(h)). Note: the reference truncates to
    (len(h)+1)//2 taps here (generate_minimum_phase.py:96-117, a scipy API
    artifact) and then zero-pads back to the aligned tap count — which costs
    ~80-100 dB of achievable stopband attenuation for tightly-designed
    filters. Keeping the full length at the identical artifact size is
    strictly better, so we do.
    """
    h = np.asarray(h, dtype=np.float64)
    n = len(h)
    if n_out is None:
        n_out = n
    if n_fft is None:
        n_fft = 2 ** int(math.ceil(math.log2(8 * n)))
    if n_fft < n:
        raise ValueError(f"n_fft ({n_fft}) must be >= len(h) ({n})")

    spectrum = np.fft.fft(h, n_fft)
    eps = np.finfo(np.float64).eps
    log_mag = np.log(np.maximum(np.abs(spectrum), eps))
    cepstrum = np.fft.ifft(log_mag).real

    # Fold: c_min[0] = c[0]; c_min[1:N/2] = 2c[1:N/2]; c_min[N/2] = c[N/2].
    window = np.zeros(n_fft)
    window[0] = 1.0
    half = n_fft // 2
    if n_fft % 2 == 0:
        window[1:half] = 2.0
        window[half] = 1.0
    else:
        window[1 : half + 1] = 2.0
    h_min_full = np.fft.ifft(np.exp(np.fft.fft(cepstrum * window))).real
    return h_min_full[:n_out]


def normalize_dc_gain(
    h: np.ndarray, target_dc_gain: float, headroom: float = DC_GAIN_HEADROOM
) -> tuple[np.ndarray, dict]:
    """Scale taps so sum(h) == target_dc_gain * headroom.

    Returns (scaled taps, report) — the report mirrors the reference's
    normalization block in the sidecar JSON (generate_filter.py:473-519).
    """
    h = np.asarray(h, dtype=np.float64)
    original_dc = float(np.sum(h))
    if original_dc == 0.0:
        raise ValueError("filter has zero DC gain; cannot normalize")
    target = target_dc_gain * headroom
    scale = target / original_dc
    out = h * scale
    report = {
        "original_dc_gain": original_dc,
        "target_dc_gain": float(target_dc_gain),
        "dc_gain_factor": float(headroom),
        "normalized_dc_gain": float(np.sum(out)),
        "applied_scale": float(scale),
        "l1_norm": float(np.sum(np.abs(out))),
        "l1_norm_ratio": float(np.sum(np.abs(out)) / target_dc_gain),
        "max_coefficient_amplitude": float(np.max(np.abs(out))),
        "normalization_applied": True,
    }
    return out, report


def design_filter(spec: FilterSpec) -> tuple[np.ndarray, dict]:
    """Full design pipeline: Kaiser lowpass [-> minimum phase] -> align -> normalize.

    Returns (float64 taps of length spec.aligned_taps, design report).
    """
    h_linear = design_kaiser_lowpass(spec)
    aligned = spec.aligned_taps
    if spec.phase == "minimum":
        h = minimum_phase_homomorphic(h_linear, n_out=aligned)
    else:
        h = h_linear
    if len(h) > aligned:
        h = h[:aligned]
    elif len(h) < aligned:
        h = np.pad(h, (0, aligned - len(h)))
    h, norm_report = normalize_dc_gain(h, spec.target_dc_gain)
    report = {
        "n_taps_specified": spec.n_taps,
        "n_taps_actual": aligned,
        "sample_rate_input": spec.input_rate,
        "sample_rate_output": spec.output_rate,
        "upsample_ratio": spec.upsample_ratio,
        "passband_end_hz": spec.passband_end_hz,
        "stopband_start_hz": spec.stopband_start_hz,
        "target_stopband_attenuation_db": spec.stopband_attenuation_db,
        "kaiser_beta": spec.kaiser_beta,
        "minimum_phase_method": "homomorphic" if spec.phase == "minimum" else None,
        "target_dc_gain": spec.target_dc_gain,
        "normalization": norm_report,
    }
    return h, report


def calculate_safe_gain(filter_sets: dict[str, np.ndarray]) -> dict:
    """Global safe digital gain from the worst-case coefficient amplitude
    across filters (reference: generate_filter.py:557-604)."""
    max_amp = max(float(np.max(np.abs(h))) for h in filter_sets.values())
    # Keep |h|_max * gain <= 1.0 to avoid inter-sample clipping headroom issues.
    safe_gain = 1.0 / max_amp if max_amp > 0 else 1.0
    return {
        "max_coefficient_amplitude": max_amp,
        "recommended_max_gain_linear": safe_gain,
        "recommended_max_gain_db": 20.0 * math.log10(safe_gain) if safe_gain > 0 else 0.0,
    }
