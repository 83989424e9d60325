"""Mirics MiriSDR input driver via libmirisdr (ctypes).

Semantic model of the reference driver (reference: src/input-mirisdr.cpp):
s8 IQ format, frequency correction in Hz rather than ppm
(input-mirisdr.h:26-33), device by index or serial, gain set directly in dB
(input-mirisdr.cpp:150-240).  Gated on libmirisdr presence.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from .base import Input, InputState


def _load():
    name = ctypes.util.find_library("mirisdr")
    if not name:
        return None
    try:
        return ctypes.CDLL(name)
    except OSError:
        return None


_LIB = _load()


def mirisdr_available() -> bool:
    return _LIB is not None


class MiriSdrInput(Input):
    sample_format = "s8"
    bytes_per_sample = 2
    fullscale = 127.5

    def __init__(
        self,
        sample_rate: int = 2_560_000,
        centerfreq: int = 0,
        index: int = 0,
        serial: str | None = None,
        gain: float | None = None,
        correction: float = 0.0,  # Hz, not ppm (input-mirisdr.h:26-33)
        buf_size: int = 10 * 320_000,
        extra: int = 0,
    ):
        super().__init__(sample_rate, centerfreq, buf_size=buf_size, extra=extra)
        self.index = index
        self.serial = serial
        self.gain = gain
        self.correction_hz = correction
        self.dev = ctypes.c_void_p()

    def _find_by_serial(self) -> int:
        """reference: mirisdr_find_device_by_serial (input-mirisdr.cpp:72-86)."""
        n = _LIB.mirisdr_get_device_count()
        m = ctypes.create_string_buffer(256)
        p = ctypes.create_string_buffer(256)
        s = ctypes.create_string_buffer(256)
        for i in range(n):
            _LIB.mirisdr_get_device_usb_strings(i, m, p, s)
            if s.value.decode() == self.serial:
                return i
        raise RuntimeError(f"no MiriSDR device with serial {self.serial!r}")

    def init(self) -> None:
        if _LIB is None:
            self.state = InputState.FAILED
            raise RuntimeError("libmirisdr not found — mirisdr input unavailable")
        if self.serial is not None:
            self.index = self._find_by_serial()
        if _LIB.mirisdr_open(ctypes.byref(self.dev), self.index) != 0:
            self.state = InputState.FAILED
            raise RuntimeError(f"mirisdr_open({self.index}) failed")
        _LIB.mirisdr_set_sample_rate(self.dev, int(self.sample_rate))
        _LIB.mirisdr_set_center_freq(self.dev, int(self.centerfreq + self.correction_hz))
        if self.gain is not None:
            _LIB.mirisdr_set_tuner_gain_mode(self.dev, 1)
            _LIB.mirisdr_set_tuner_gain(self.dev, int(self.gain))
        _LIB.mirisdr_set_sample_format(self.dev, b"252_S16")
        _LIB.mirisdr_reset_buffer(self.dev)
        self.state = InputState.INITIALIZED

    def set_centerfreq(self, freq: int) -> bool:
        self.centerfreq = freq
        return _LIB.mirisdr_set_center_freq(self.dev, int(freq + self.correction_hz)) == 0

    def _rx_loop(self) -> None:
        BUFLEN = 320_000
        buf = ctypes.create_string_buffer(BUFLEN)
        nread = ctypes.c_int(0)
        while not self._stop.is_set():
            if _LIB.mirisdr_read_sync(self.dev, buf, BUFLEN, ctypes.byref(nread)) != 0:
                self.state = InputState.FAILED
                return
            self.ring.append(buf.raw[: nread.value])

    def stop(self) -> None:
        super().stop()
        if self.dev:
            _LIB.mirisdr_close(self.dev)
            self.dev = ctypes.c_void_p()


INPUT_CLASS = MiriSdrInput
