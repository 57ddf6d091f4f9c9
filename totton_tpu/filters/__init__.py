"""Offline FIR filter design toolkit.

Rebuild of the reference's scripts/filters/ package
(generate_filter.py, generate_minimum_phase.py, generate_linear_phase.py):
Kaiser-window lowpass design, homomorphic minimum-phase conversion, DC-gain
normalization, validation, and export to the .bin + .json sidecar format
(reference schema: docs/filter_format.md).
"""

from totton_tpu.filters.design import (
    FilterSpec,
    MULTI_RATE_SPECS,
    aligned_tap_count,
    design_kaiser_lowpass,
    design_filter,
    minimum_phase_homomorphic,
    normalize_dc_gain,
)
from totton_tpu.filters.sidecar import (
    FilterSidecar,
    LoadedFilter,
    load_filter,
    save_filter,
    overlap_save_geometry,
)
from totton_tpu.filters.validate import validate_filter

__all__ = [
    "FilterSpec",
    "MULTI_RATE_SPECS",
    "aligned_tap_count",
    "design_kaiser_lowpass",
    "design_filter",
    "minimum_phase_homomorphic",
    "normalize_dc_gain",
    "FilterSidecar",
    "LoadedFilter",
    "load_filter",
    "save_filter",
    "overlap_save_geometry",
    "validate_filter",
]
