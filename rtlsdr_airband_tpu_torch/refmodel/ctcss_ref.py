"""Scalar reference CTCSS tone detection (Goertzel bank), NumPy float32.

Behavioral transcription of the reference detector for golden testing
(reference: src/ctcss.cpp, src/ctcss.h).  The vectorized demod in
ops/demod.py (and the kernel K1) must match this sample-for-sample.
"""

from __future__ import annotations

import numpy as np

from ..ops.goertzel import STANDARD_TONES, goertzel_coeff

F32 = np.float32


class ToneDetectorRef:
    """Single-tone Goertzel recurrence. reference: src/ctcss.cpp:31-61."""

    def __init__(self, tone_freq: float, sample_rate: float, window_size: int):
        self.tone_freq = F32(tone_freq)
        self.magnitude = F32(0.0)
        self.window_size = int(window_size)
        self.coeff = goertzel_coeff(tone_freq, sample_rate, window_size)
        self.reset()

    def process_sample(self, sample: np.float32) -> None:
        q0 = self.coeff * self.q1 - self.q2 + F32(sample)
        self.q2 = self.q1
        self.q1 = q0
        self.count += 1
        if self.count == self.window_size:
            self.magnitude = self.q1 * self.q1 + self.q2 * self.q2 - self.q1 * self.q2 * self.coeff
            self.count = 0

    def reset(self) -> None:
        self.count = 0
        self.q1 = F32(0.0)
        self.q2 = F32(0.0)


class CTCSSRef:
    """Dual-purpose tone detector bank gate. reference: src/ctcss.cpp:105-185."""

    def __init__(self, ctcss_freq: float = 0.0, sample_rate: float = 8000.0, window_size: int = 0):
        self.enabled = ctcss_freq > 0.0 and window_size > 0
        self.ctcss_freq = F32(ctcss_freq)
        self.window_size = int(window_size)
        self.found_count = 0
        self.not_found_count = 0
        self.tones: list[ToneDetectorRef] = []
        if self.enabled:
            # Target tone first, then standard tones except within +/-5 Hz of
            # target or with colliding float32 coefficients.
            self._add(ctcss_freq, sample_rate)
            for tone in STANDARD_TONES:
                if abs(ctcss_freq - tone) < 5:
                    continue
                self._add(float(tone), sample_rate)
        self.reset()

    def _add(self, freq: float, sample_rate: float) -> bool:
        det = ToneDetectorRef(freq, sample_rate, self.window_size)
        for t in self.tones:
            if t.coeff == det.coeff:
                return False
        self.tones.append(det)
        return True

    def process_audio_sample(self, sample: np.float32) -> None:
        if not self.enabled:
            return
        for t in self.tones:
            t.process_sample(sample)
        self.sample_count += 1
        if self.sample_count < self.window_size:
            return
        self.enough_samples = True
        powers = np.array([t.magnitude for t in self.tones], dtype=F32)
        avg_power = F32(powers.sum(dtype=F32) / F32(len(self.tones)))
        target = powers[0]
        if target == powers.max() and target > avg_power:
            self.has_tone = True
            self.found_count += 1
        else:
            self.has_tone = False
            self.not_found_count += 1
        for t in self.tones:
            t.reset()
        self.sample_count = 0

    def reset(self) -> None:
        if self.enabled:
            for t in self.tones:
                t.reset()
            self.enough_samples = False
            self.sample_count = 0
            self.has_tone_flag = False
            self.has_tone = False
        else:
            self.enough_samples = False
            self.sample_count = 0
            self.has_tone = False

    def is_enabled(self) -> bool:
        return self.enabled

    def get_has_tone(self) -> bool:
        """has_tone() accessor semantics: true when disabled."""
        return (not self.enabled) or self.has_tone
