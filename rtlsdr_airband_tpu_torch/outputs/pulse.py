"""PulseAudio sinks (reference: src/pulse.cpp).

:func:`make_pulse_output` prefers the ASYNC threaded-mainloop implementation
(outputs/pulse_async.py — corked synchronized L/R mono stream pair, latency
cap, reconnect; the reference's model) when libpulse is present, and falls
back to this module's libpulse-SIMPLE blocking sink (one interleaved s16
write per 125 ms batch — functionally equivalent for mono, and stereo as a
single 2-channel stream which cannot desynchronize).  With neither library
the output disables itself and reports ``available = False`` (the app layer
logs and drops it).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np


def _load():
    name = ctypes.util.find_library("pulse-simple")
    if not name:
        return None
    try:
        return ctypes.CDLL(name)
    except OSError:
        return None


_LIB = _load()

PA_STREAM_PLAYBACK = 1
PA_SAMPLE_S16LE = 3


class _SampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32), ("channels", ctypes.c_uint8)]


class PulseOutput:
    def __init__(self, sample_rate: int, stereo: bool = False, server: str | None = None, sink: str | None = None, stream_name: str = "rtlsdr-airband-tpu"):
        self.available = _LIB is not None
        self.s = None
        self.stereo = stereo
        if not self.available:
            return
        spec = _SampleSpec(PA_SAMPLE_S16LE, sample_rate, 2 if stereo else 1)
        err = ctypes.c_int(0)
        _LIB.pa_simple_new.restype = ctypes.c_void_p
        self.s = _LIB.pa_simple_new(
            server.encode() if server else None,
            b"rtlsdr-airband-tpu",
            PA_STREAM_PLAYBACK,
            sink.encode() if sink else None,
            stream_name.encode(),
            ctypes.byref(spec),
            None,
            None,
            ctypes.byref(err),
        )
        if not self.s:
            self.available = False

    def write(self, left: np.ndarray, right: np.ndarray | None = None) -> None:
        if not self.available or self.s is None:
            return
        left = np.clip(np.asarray(left, np.float32), -1, 1)
        if self.stereo:
            r = np.clip(np.asarray(right if right is not None else left, np.float32), -1, 1)
            buf = np.empty(left.size * 2, np.float32)
            buf[0::2] = left
            buf[1::2] = r
        else:
            buf = left
        pcm = (buf * 32767.0).astype("<i2").tobytes()
        err = ctypes.c_int(0)
        if _LIB.pa_simple_write(self.s, pcm, len(pcm), ctypes.byref(err)) < 0:
            self.available = False

    def close(self) -> None:
        if self.available and self.s is not None:
            _LIB.pa_simple_free(self.s)
            self.s = None
            self.available = False


def make_pulse_output(sample_rate: int, stereo: bool = False, server: str | None = None, sink: str | None = None, stream_name: str = "rtlsdr-airband-tpu", continuous: bool = False):
    """Best-available Pulse sink: async threaded-mainloop (reference model)
    when libpulse is present, else the simple-API fallback."""
    try:
        from . import pulse_async

        if pulse_async.available():
            return pulse_async.PulseAsyncOutput(
                sample_rate, stereo=stereo, server=server, sink=sink,
                stream_name=stream_name, continuous=continuous,
            )
    except Exception:
        pass
    return PulseOutput(sample_rate, stereo=stereo, server=server, sink=sink, stream_name=stream_name)
