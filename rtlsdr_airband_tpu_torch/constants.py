"""Framework-wide constants (reference: src/rtl_airband.h:64-97).

A copy of what the port uses from ``rtlsdr_airband_tpu/constants.py``.
"""

from __future__ import annotations

# Look-back / look-ahead margin for AGC and squelch (samples).
# reference: rtl_airband.h:75 (AGC_EXTRA = 100)
AGC_EXTRA = 100
