"""Scalar reference IIR filters (NumPy, float32 recurrences).

Behavioral transcription of the reference filters for golden testing of the
vectorized demod (reference: src/filters.cpp).  Coefficient design is
shared with the port's ``ops/filters.py``; here we keep the exact
sample-by-sample recurrence and state layout.
"""

from __future__ import annotations

import numpy as np

from ..ops.filters import LowpassCoeffs, NotchCoeffs, design_bessel_lowpass, design_notch

F32 = np.float32


class NotchFilterRef:
    """2nd-order audio notch. reference: src/filters.cpp:30-64."""

    def __init__(self, notch_freq: float = 0.0, sample_freq: float = 8000.0, q: float = 10.0):
        self.coeffs: NotchCoeffs = design_notch(notch_freq, sample_freq, q)
        self.enabled = self.coeffs.enabled
        self.x = np.zeros(3, dtype=F32)
        self.y = np.zeros(3, dtype=F32)

    def apply(self, value: np.float32) -> np.float32:
        if not self.enabled:
            return value
        d0, d1, d2 = F32(self.coeffs.d0), F32(self.coeffs.d1), F32(self.coeffs.d2)
        x, y = self.x, self.y
        x[0], x[1], x[2] = x[1], x[2], F32(value)
        y[0], y[1] = y[1], y[2]
        y[2] = d0 * x[2] - d1 * x[1] + d0 * x[0] + d1 * y[1] - d2 * y[0]
        return y[2]


class LowpassFilterRef:
    """2nd-order complex Bessel lowpass. reference: src/filters.cpp:69-180."""

    def __init__(self, freq: float = 0.0, sample_freq: float = 8000.0):
        self.coeffs: LowpassCoeffs = design_bessel_lowpass(freq, sample_freq)
        self.enabled = self.coeffs.enabled
        self.xv = np.zeros(3, dtype=np.complex64)
        self.yv = np.zeros(3, dtype=np.complex64)

    def apply(self, r: np.float32, j: np.float32) -> tuple[np.float32, np.float32]:
        if not self.enabled:
            return r, j
        gain = F32(self.coeffs.gain)
        y0, y1 = F32(self.coeffs.ycoeff0), F32(self.coeffs.ycoeff1)
        xv, yv = self.xv, self.yv
        xv[0], xv[1] = xv[1], xv[2]
        xv[2] = np.complex64(complex(F32(r), F32(j))) / gain
        yv[0], yv[1] = yv[1], yv[2]
        yv[2] = (xv[0] + xv[2]) + F32(2.0) * xv[1] + y0 * yv[0] + y1 * yv[1]
        return np.float32(yv[2].real), np.float32(yv[2].imag)
