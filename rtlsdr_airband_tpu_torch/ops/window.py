"""Analysis window generation.

The channelizer multiplies each FFT frame by a 7-term Blackman-Harris window
(reference: src/rtl_airband.cpp:335-351). The window is computed in float64
and cast to float32, matching the reference's double-precision generation.
"""

from __future__ import annotations

import numpy as np

# 7-term Blackman-Harris coefficients (reference: rtl_airband.cpp:335-341).
_BH7_COEFFS = (
    0.27105140069342,
    0.43329793923448,
    0.21812299954311,
    0.06592544638803,
    0.01081174209837,
    0.00077658482522,
    0.00001388721735,
)


def blackman_harris_7(n: int, dtype=np.float32) -> np.ndarray:
    """Length-``n`` 7-term Blackman-Harris window (periodic over n-1)."""
    i = np.arange(n, dtype=np.float64)
    x = np.full(n, _BH7_COEFFS[0], dtype=np.float64)
    sign = -1.0
    for m, a in enumerate(_BH7_COEFFS[1:], start=1):
        x += sign * a * np.cos((2.0 * np.pi * m * i) / (n - 1))
        sign = -sign
    return x.astype(dtype)
