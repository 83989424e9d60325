"""Raw IQ sample-format decoding on the host (numpy).

Counterpart of ``rtlsdr_airband_tpu/ops/sampleconv.py``: converts raw
interleaved IQ byte streams (u8/s8/s16/f32) to float32 [n, 2] pairs with the
reference's level mappings (reference: src/rtl_airband.cpp:316-324 for the
u8/s8 LUTs, :402-438 for s16/f32 scaling).  ``Pipeline._decode`` uses it for
the streams it decodes on the host; raw u8/s8/s16 streams are decoded on the
device by ``ops.channelizer.decode_raw_iq``, to the same bits.
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class SampleFormat(str, Enum):
    U8 = "u8"  # CU8: (x - 127.5) / 127.5
    S8 = "s8"  # CS8: x / 128
    S16 = "s16"  # CS16: x / fullscale
    F32 = "f32"  # CF32: x / fullscale


def default_fullscale(sfmt: SampleFormat) -> float:
    return {"u8": 127.5, "s8": 128.0, "s16": 32768.0, "f32": 1.0}[sfmt.value]


def make_u8_lut() -> np.ndarray:
    i = np.arange(256, dtype=np.float32)
    return (i - np.float32(127.5)) / np.float32(127.5)


def make_s8_lut() -> np.ndarray:
    """Indexed by the signed byte reinterpreted as u8 (two's complement)."""
    lut = np.zeros(256, dtype=np.float32)
    for i in range(-128, 128):
        lut[i & 0xFF] = np.float32(i) / np.float32(128.0)
    return lut


def decode_iq(raw: bytes | np.ndarray, sfmt: SampleFormat, fullscale: float | None = None) -> np.ndarray:
    """Decode interleaved IQ bytes to a float32 array [n, 2] (I, Q)."""
    if fullscale is None:
        fullscale = default_fullscale(sfmt)
    if sfmt == SampleFormat.U8:
        x = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.uint8)
        out = make_u8_lut()[x]
    elif sfmt == SampleFormat.S8:
        x = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw).view(np.uint8)
        out = make_s8_lut()[x]
    elif sfmt == SampleFormat.S16:
        x = np.frombuffer(raw, dtype=np.int16) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.int16)
        out = x.astype(np.float32) * np.float32(1.0 / fullscale)
    elif sfmt == SampleFormat.F32:
        x = np.frombuffer(raw, dtype=np.float32) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, dtype=np.float32)
        out = x * np.float32(1.0 / fullscale)
    else:  # pragma: no cover
        raise ValueError(f"unknown sample format {sfmt}")
    return out.reshape(-1, 2)
