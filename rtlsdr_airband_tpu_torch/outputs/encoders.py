"""Audio byte-stream encoders for the output sinks.

The reference encodes every audio batch once per channel with LAME
(reference: src/output.cpp:456-462, airlame_init output.cpp:148-172) and fans
the MP3 bytes out to all sinks.  Here the encoder is a host-side component
behind a small byte-stream interface; MP3 binds ``libmp3lame`` directly via
ctypes (``lame_encode_buffer_ieee_float`` per batch, like the reference),
with WAV (PCM s16) as the always-available fallback when the shared library
is absent, matching the reference's rates: in 8/16 kHz -> out 8 kHz mono,
VBR quality 7, bitrate 16.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Protocol

import numpy as np


def _load_lame():
    name = ctypes.util.find_library("mp3lame") or "libmp3lame.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fn in (
        "lame_set_in_samplerate", "lame_set_VBR", "lame_set_brate", "lame_set_quality",
        "lame_set_lowpassfreq", "lame_set_highpassfreq", "lame_set_out_samplerate",
        "lame_set_num_channels", "lame_set_mode", "lame_init_params",
    ):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int][: 2 if fn != "lame_init_params" else 1]
    lib.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.lame_encode_flush_nogap.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.lame_close.argtypes = [ctypes.c_void_p]
    return lib


_LAME = _load_lame()

# lame.h enums
_VBR_MTRH = 4
_JOINT_STEREO = 1
_MONO = 3
LAMEBUF_SIZE = 22000  # reference: rtl_airband.h LAMEBUF_SIZE
MP3_RATE = 8000  # reference: rtl_airband.h MP3_RATE


def lame_available() -> bool:
    return _LAME is not None


class AudioEncoder(Protocol):
    suffix: str

    def encode(self, samples: np.ndarray, right: np.ndarray | None = None) -> bytes: ...
    def flush(self) -> bytes: ...


def _to_pcm16(samples: np.ndarray) -> np.ndarray:
    x = np.clip(np.nan_to_num(np.asarray(samples, np.float32)), -1.0, 1.0)
    return (x * 32767.0).astype("<i2")


def _interleave(left: np.ndarray, right: np.ndarray | None) -> np.ndarray:
    left = np.asarray(left, np.float32)
    if right is None:
        return left
    right = np.asarray(right, np.float32)
    buf = np.empty(left.size + right.size, np.float32)
    buf[0::2] = left
    buf[1::2] = right
    return buf


class RawEncoder:
    """float32 little-endian pass-through (the O_RAWFILE cf32 analog for
    audio; IQ rawfile output writes complex64 directly)."""

    suffix = ".f32"

    def __init__(self, sample_rate: int, stereo: bool = False):
        del sample_rate, stereo

    def encode(self, samples: np.ndarray, right: np.ndarray | None = None) -> bytes:
        return np.nan_to_num(_interleave(samples, right)).tobytes()

    def flush(self) -> bytes:
        return b""


class WavEncoder:
    """Streaming WAV: emits a RIFF header with 0xFFFFFFFF sizes (the
    standard streaming-WAV convention) followed by PCM s16 frames; players
    and the file manager's finalize step handle the open-ended size."""

    suffix = ".wav"

    def __init__(self, sample_rate: int, stereo: bool = False):
        self.sample_rate = sample_rate
        self.channels = 2 if stereo else 1
        self._header_sent = False

    def header(self) -> bytes:
        ch, sr = self.channels, self.sample_rate
        return (
            b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF)
        )

    def encode(self, samples: np.ndarray, right: np.ndarray | None = None) -> bytes:
        out = b""
        if not self._header_sent:
            out = self.header()
            self._header_sent = True
        return out + _to_pcm16(_interleave(samples, right)).tobytes()

    def flush(self) -> bytes:
        return b""


class Mp3Encoder:
    """MP3 via libmp3lame (ctypes), one context per channel.

    Mirrors airlame_init (reference: output.cpp:148-172): mono (or joint
    stereo), VBR_MTRH, mean bitrate 16 kbit/s, quality 7, output resampled
    to MP3_RATE=8 kHz, optional highpass/lowpass shaping (default
    100/2500 Hz, reference: config.cpp:322-323).  Batch encode uses
    lame_encode_buffer_ieee_float like process_outputs (output.cpp:458-462).
    """

    suffix = ".mp3"

    def __init__(self, sample_rate: int, stereo: bool = False, highpass: int = 100, lowpass: int = 2500):
        if _LAME is None:
            raise RuntimeError("libmp3lame not found")
        self.stereo = stereo
        gfp = _LAME.lame_init()
        _LAME.lame_set_in_samplerate(gfp, int(sample_rate))
        _LAME.lame_set_VBR(gfp, _VBR_MTRH)
        _LAME.lame_set_brate(gfp, 16)
        _LAME.lame_set_quality(gfp, 7)
        _LAME.lame_set_lowpassfreq(gfp, int(lowpass))
        _LAME.lame_set_highpassfreq(gfp, int(highpass))
        _LAME.lame_set_out_samplerate(gfp, MP3_RATE)
        if stereo:
            _LAME.lame_set_num_channels(gfp, 2)
            _LAME.lame_set_mode(gfp, _JOINT_STEREO)
        else:
            _LAME.lame_set_num_channels(gfp, 1)
            _LAME.lame_set_mode(gfp, _MONO)
        _LAME.lame_init_params(gfp)
        self._gfp = gfp
        self._buf = ctypes.create_string_buffer(LAMEBUF_SIZE)

    def encode(self, samples: np.ndarray, right: np.ndarray | None = None) -> bytes:
        """samples: mono float array (or left channel when stereo)."""
        if self._gfp is None:
            return b""
        left = np.ascontiguousarray(np.nan_to_num(np.asarray(samples, np.float32)))
        if self.stereo:
            r = np.ascontiguousarray(np.asarray(right if right is not None else samples, np.float32))
            rp = r.ctypes.data_as(ctypes.c_void_p)
        else:
            rp = None
        n = _LAME.lame_encode_buffer_ieee_float(
            self._gfp, left.ctypes.data_as(ctypes.c_void_p), rp, left.size, self._buf, LAMEBUF_SIZE
        )
        return self._buf.raw[: max(0, n)]

    def flush(self) -> bytes:
        if self._gfp is None:
            return b""
        n = _LAME.lame_encode_flush_nogap(self._gfp, self._buf, LAMEBUF_SIZE)
        return self._buf.raw[: max(0, n)]

    def close(self) -> None:
        if self._gfp is not None:
            _LAME.lame_close(self._gfp)
            self._gfp = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_encoder(kind: str, sample_rate: int, stereo: bool = False, **kw) -> AudioEncoder:
    """kind: 'mp3' | 'wav' | 'raw' | 'auto' (mp3 if lame present else wav)."""
    if kind == "auto":
        kind = "mp3" if lame_available() else "wav"
    if kind == "mp3":
        return Mp3Encoder(sample_rate, stereo, **kw)
    if kind == "wav":
        return WavEncoder(sample_rate, stereo)
    if kind == "raw":
        return RawEncoder(sample_rate, stereo)
    raise ValueError(f"unknown encoder kind {kind!r}")
