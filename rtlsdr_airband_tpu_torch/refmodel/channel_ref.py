"""Channel-to-FFT-bin assignment of the reference (config.cpp:661-664)."""

from __future__ import annotations

import numpy as np


def bin_for_freq(freq: int, center_freq: int, sample_rate: int, fft_size: int) -> int:
    """FFT bin assignment, incl. the reference's integer-divide bin width."""
    bin_width = sample_rate // fft_size
    return int(np.ceil((freq + sample_rate - center_freq) / float(bin_width) - 1.0)) % fft_size
