"""IIR filter coefficient design: audio notch and complex Bessel lowpass.

Coefficient math follows the reference designs so filter output matches:
 - NotchFilter: 2nd-order notch from frequency/Q (reference: src/filters.cpp:30-64)
 - LowpassFilter: 2nd-order lowpass Bessel via bilinear transform of a fixed
   analog prototype pole pair (reference: src/filters.cpp:69-144)

Design is done in float64 (the reference uses double), the runtime recurrence
uses float32.  Disabled filters carry harmless coefficients; the demod
bypasses them by their ``enabled`` flag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Analog prototype pole for the 2nd-order Bessel lowpass (reference: filters.cpp:84).
_BESSEL2_POLE = complex(-1.10160133059, 0.636009824757)


@dataclass(frozen=True)
class NotchCoeffs:
    """y[n] = d0*x[n] - d1*x[n-1] + d0*x[n-2] + d1*y[n-1] - d2*y[n-2]"""

    d0: float
    d1: float
    d2: float
    enabled: bool

    @staticmethod
    def disabled() -> "NotchCoeffs":
        # Identity passthrough: y[n] = x[n].
        return NotchCoeffs(d0=1.0, d1=0.0, d2=0.0, enabled=False)


def design_notch(notch_freq: float, sample_rate: float, q: float = 10.0) -> NotchCoeffs:
    if notch_freq <= 0.0:
        return NotchCoeffs.disabled()
    wo = 2.0 * np.pi * (notch_freq / sample_rate)
    e = 1.0 / (1.0 + np.tan(wo / (q * 2.0)))
    p = np.cos(wo)
    return NotchCoeffs(d0=float(e), d1=float(2.0 * e * p), d2=float(2.0 * e - 1.0), enabled=True)


@dataclass(frozen=True)
class LowpassCoeffs:
    """Complex biquad: y[n] = (x[n-2] + x[n]) + 2*x[n-1] + y0c*y[n-2] + y1c*y[n-1],
    with x scaled by 1/gain on input."""

    gain: float
    ycoeff0: float
    ycoeff1: float
    enabled: bool

    @staticmethod
    def disabled() -> "LowpassCoeffs":
        # the recurrence is bypassed by ``enabled``; these values only keep
        # its unused arithmetic finite
        return LowpassCoeffs(gain=1.0, ycoeff0=0.0, ycoeff1=0.0, enabled=False)


def _expand_poly(roots: np.ndarray) -> np.ndarray:
    """Polynomial coefficients (ascending powers) of prod (z - r)."""
    npz = len(roots)
    coeffs = np.zeros(npz + 1, dtype=np.complex128)
    coeffs[0] = 1.0
    for w in roots:
        nw = -w
        for i in range(npz, 0, -1):
            coeffs[i] = nw * coeffs[i] + coeffs[i - 1]
        coeffs[0] = nw * coeffs[0]
    return coeffs


def _eval_poly(coeffs: np.ndarray, z: complex) -> complex:
    s = 0.0 + 0.0j
    for c in coeffs[::-1]:
        s = s * z + c
    return s


def design_bessel_lowpass(cutoff_freq: float, sample_rate: float) -> LowpassCoeffs:
    """2nd-order Bessel lowpass at ``cutoff_freq`` for complex IQ at ``sample_rate``."""
    if cutoff_freq <= 0.0:
        return LowpassCoeffs.disabled()

    raw_alpha = float(cutoff_freq) / float(sample_rate)
    warped_alpha = np.tan(np.pi * raw_alpha) / np.pi

    def blt(pz: complex) -> complex:
        return (2.0 + pz) / (2.0 - pz)

    w = 2.0 * np.pi * warped_alpha
    poles = np.array(
        [blt(w * _BESSEL2_POLE), blt(w * np.conj(_BESSEL2_POLE))], dtype=np.complex128
    )
    zeros = np.array([-1.0, -1.0], dtype=np.complex128)

    top = _expand_poly(zeros)
    bot = _expand_poly(poles)
    g = _eval_poly(top, 1.0 + 0.0j) / _eval_poly(bot, 1.0 + 0.0j)
    gain = float(np.hypot(g.imag, g.real))
    yc = [-(bot[i].real / bot[2].real) for i in range(3)]
    return LowpassCoeffs(gain=gain, ycoeff0=float(yc[0]), ycoeff1=float(yc[1]), enabled=True)
