"""Fixed-point phase and interpolated sin/cos lookup tables.

The derotator uses a 24-bit fixed-point phase accumulator and a 256-entry
linearly interpolated sin/cos table (reference: src/util.cpp:103-127, applied
at src/rtl_airband.cpp:510-517).
"""

from __future__ import annotations

import numpy as np

LUT_SIZE = 256


def make_sincos_tables(dtype=np.float32):
    """257-entry sin/cos tables (last entry wraps). reference: util.cpp:105-110."""
    i = np.arange(LUT_SIZE, dtype=np.float32)
    ang = (2.0 * np.pi * i / float(LUT_SIZE)).astype(np.float32)
    sin_lut = np.sin(ang).astype(dtype)
    cos_lut = np.cos(ang).astype(dtype)
    sin_lut = np.concatenate([sin_lut, sin_lut[:1]])
    cos_lut = np.concatenate([cos_lut, cos_lut[:1]])
    return sin_lut, cos_lut


def compute_dm_dphi(channel_freq: int, center_freq: int, sample_rate: int, wave_rate: int) -> int:
    """Per-audio-sample derotation phase increment, 24-bit fixed point.

    Includes the correction for the fractional error of rounding
    sample_rate/wave_rate to an integer hop. reference: config.cpp:679-712.
    Returns a python int in [0, 2^32) (uint32 semantics of the reference).
    """
    dm_dphi = float(channel_freq - center_freq)
    decimation_factor = float(sample_rate) / float(wave_rate)
    correction = (wave_rate / 2.0) * (decimation_factor - round(decimation_factor))
    correction *= float(channel_freq - center_freq) / (sample_rate / 2.0)
    dm_dphi -= correction
    dm_dphi /= float(wave_rate)
    dm_dphi -= np.trunc(dm_dphi)
    dm_dphi *= 256.0 * 65536.0
    # Cast through signed int (reference: config.cpp:709), then uint32.
    return int(np.int64(int(dm_dphi)) & 0xFFFFFFFF)
