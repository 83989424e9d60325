"""Signal level from dBFS.

The FFT-size-aware conversion of a manual squelch threshold (reference:
src/util.cpp:163-180). Levels here are linear bin magnitudes as
produced by the unnormalized windowed DFT channelizer.
"""

from __future__ import annotations

import numpy as np


def dbfs_offset(fft_size: int) -> float:
    return 7.54 + 10.0 * np.log10(fft_size / 2) - 2.38


def dbfs_to_level(dbfs: float, fft_size: int) -> float:
    return float(10.0 ** ((dbfs - dbfs_offset(fft_size)) / 20.0) * fft_size)

