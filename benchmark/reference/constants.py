"""Framework-wide constants (reference: src/rtl_airband.h:64-97).

A frozen copy of the port's ``constants.py``.
"""

from __future__ import annotations

# Default SDR sample rate (samples/sec, complex IQ). reference: rtl_airband.h:64-65
DEFAULT_SAMPLE_RATE = 2_560_000

# Look-back / look-ahead margin for AGC and squelch (samples).
# reference: rtl_airband.h:75 (AGC_EXTRA = 100)
AGC_EXTRA = 100
