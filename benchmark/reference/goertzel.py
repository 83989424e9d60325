"""CTCSS tone squelch: Goertzel detector bank construction.

Each CTCSS-enabled channel runs two detector banks over demodulated audio: a
"fast" one (0.05 s window) and a "slow" one (0.4 s window).  Each bank holds
one Goertzel recurrence per candidate tone: the configured target tone first,
then every standard CTCSS tone except those within +/-5 Hz of the target or
whose float32 Goertzel coefficient collides with an already-added tone
(reference: src/ctcss.cpp:31-122, src/squelch.cpp:110-116).

The bank is represented as fixed-size arrays so the whole channel population
runs as one vectorized recurrence: [n_channels, MAX_TONES] coefficients plus a
validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# reference: ctcss.cpp:101-103
STANDARD_TONES = np.array(
    [
        67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4,
        100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5,
        141.3, 146.2, 150.0, 151.4, 156.7, 159.8, 162.2, 165.5, 167.9, 171.3,
        173.8, 177.3, 179.9, 183.5, 186.2, 189.9, 192.8, 196.6, 199.5, 203.5,
        206.5, 210.7, 218.1, 225.7, 229.1, 233.6, 241.8, 250.3, 254.1,
    ],
    dtype=np.float64,
)

MAX_TONES = len(STANDARD_TONES) + 1  # target tone + standard tones

FAST_WINDOW_SEC = 0.05  # reference: squelch.cpp:114
SLOW_WINDOW_SEC = 0.4  # reference: squelch.cpp:115


def goertzel_coeff(tone_freq: float, sample_rate: float, window_size: int) -> np.float32:
    """coeff = 2*cos(2*pi*k/N) with k = int(0.5 + N*f/fs). reference: ctcss.cpp:37-39."""
    k = int(0.5 + window_size * tone_freq / sample_rate)
    omega = (2.0 * np.pi * k) / window_size
    return np.float32(2.0 * np.cos(omega))


@dataclass
class ToneBank:
    """One detector bank (fast or slow) for one channel."""

    window_size: int
    coeffs: np.ndarray  # [MAX_TONES] float32, zero where ~mask
    mask: np.ndarray  # [MAX_TONES] bool


def build_tone_bank(ctcss_freq: float, sample_rate: float, window_size: int) -> ToneBank:
    """Target tone + de-duplicated standard tones. reference: ctcss.cpp:105-122, 61-73."""
    coeffs = np.zeros(MAX_TONES, dtype=np.float32)
    mask = np.zeros(MAX_TONES, dtype=bool)

    added: list[np.float32] = []

    def try_add(idx: int, f: float) -> bool:
        c = goertzel_coeff(f, sample_rate, window_size)
        for prev in added:
            if c == prev:  # float32 equality, as the reference compares
                return False
        coeffs[idx] = c
        mask[idx] = True
        added.append(c)
        return True

    n = 0
    if try_add(n, ctcss_freq):
        n += 1
    for tone in STANDARD_TONES:
        if abs(ctcss_freq - tone) < 5:
            continue
        if try_add(n, float(tone)):
            n += 1
    return ToneBank(window_size=window_size, coeffs=coeffs, mask=mask)


def build_ctcss_banks(ctcss_freq: float, sample_rate: float) -> tuple[ToneBank, ToneBank]:
    """(fast, slow) banks. reference: squelch.cpp:110-116."""
    fast = build_tone_bank(ctcss_freq, sample_rate, int(sample_rate * FAST_WINDOW_SEC))
    slow = build_tone_bank(ctcss_freq, sample_rate, int(sample_rate * SLOW_WINDOW_SEC))
    return fast, slow
