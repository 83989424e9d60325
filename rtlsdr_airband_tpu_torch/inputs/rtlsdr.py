"""RTL-SDR input driver via librtlsdr (ctypes).

Semantic model of the reference driver (reference: src/input-rtlsdr.cpp):
device lookup by index or serial (input-rtlsdr.cpp:72-86), nearest-gain
selection from the device's gain table (:46-70), ppm correction, tuner AGC
and internal AGC off (:141-148), u8 IQ at 2.56 Msps default
(input-rtlsdr.h:21-24).  The RX path uses rtlsdr_read_sync in the driver
thread pushing into the ring buffer — the device pipeline drains at block
cadence, so the async-callback machinery of the reference is unnecessary.
Gated on librtlsdr being present; ``init()`` raises if not.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from .base import Input, InputState

DEFAULT_SAMPLE_RATE = 2_560_000
DEFAULT_BUFFERS = 10
DEFAULT_BUFLEN = 320_000


def _load():
    name = ctypes.util.find_library("rtlsdr")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.rtlsdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32]
        return lib
    except OSError:
        return None


_LIB = _load()


def rtlsdr_available() -> bool:
    return _LIB is not None


class RtlSdrInput(Input):
    sample_format = "u8"
    bytes_per_sample = 2
    fullscale = 127.5

    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        centerfreq: int = 0,
        index: int = 0,
        serial: str | None = None,
        gain: float | None = None,
        correction: float = 0.0,
        buf_size: int = DEFAULT_BUFFERS * DEFAULT_BUFLEN,
        extra: int = 0,
    ):
        super().__init__(sample_rate, centerfreq, buf_size=buf_size, extra=extra)
        self.index = index
        self.serial = serial
        self.gain = gain
        self.correction = correction
        self.dev = ctypes.c_void_p()

    # -------------------------------------------------------------- helpers

    def _find_by_serial(self) -> int:
        """reference: input-rtlsdr.cpp:72-86."""
        n = _LIB.rtlsdr_get_device_count()
        m = ctypes.create_string_buffer(256)
        p = ctypes.create_string_buffer(256)
        s = ctypes.create_string_buffer(256)
        for i in range(n):
            if _LIB.rtlsdr_get_device_usb_strings(i, m, p, s) == 0 and s.value.decode() == self.serial:
                return i
        raise RuntimeError(f"no RTL-SDR device with serial {self.serial!r}")

    def _nearest_gain(self, want_db: float) -> int:
        """reference: input-rtlsdr.cpp:46-70 (gains are tenths of dB)."""
        count = _LIB.rtlsdr_get_tuner_gains(self.dev, None)
        if count <= 0:
            return int(want_db * 10)
        arr = (ctypes.c_int * count)()
        _LIB.rtlsdr_get_tuner_gains(self.dev, arr)
        want = int(want_db * 10)
        return min(arr, key=lambda g: abs(g - want))

    # ------------------------------------------------------------ lifecycle

    def init(self) -> None:
        if _LIB is None:
            self.state = InputState.FAILED
            raise RuntimeError("librtlsdr not found — rtlsdr input unavailable")
        idx = self._find_by_serial() if self.serial else self.index
        if _LIB.rtlsdr_open(ctypes.byref(self.dev), idx) != 0:
            self.state = InputState.FAILED
            raise RuntimeError(f"rtlsdr_open({idx}) failed")
        _LIB.rtlsdr_set_sample_rate(self.dev, int(self.sample_rate))
        _LIB.rtlsdr_set_center_freq(self.dev, int(self.centerfreq))
        if self.correction:
            _LIB.rtlsdr_set_freq_correction(self.dev, int(self.correction))
        if self.gain is not None:
            _LIB.rtlsdr_set_tuner_gain_mode(self.dev, 1)  # manual
            # Fitipower FC0012 quirk: the tuner's gain must be initialized to
            # its lowest supported value before setting the desired one
            # (reference: input-rtlsdr.cpp:121-133; RTLSDR_TUNER_FC0012 == 2
            # in librtlsdr's rtlsdr_tuner enum)
            if _LIB.rtlsdr_get_tuner_type(self.dev) == 2:
                _LIB.rtlsdr_set_tuner_gain(self.dev, self._nearest_gain(-99.0))
            _LIB.rtlsdr_set_tuner_gain(self.dev, self._nearest_gain(self.gain))
        else:
            _LIB.rtlsdr_set_tuner_gain_mode(self.dev, 0)
        _LIB.rtlsdr_set_agc_mode(self.dev, 0)  # internal AGC off (:148)
        _LIB.rtlsdr_reset_buffer(self.dev)
        self.state = InputState.INITIALIZED

    def set_centerfreq(self, freq: int) -> bool:
        self.centerfreq = freq
        return _LIB.rtlsdr_set_center_freq(self.dev, int(freq)) == 0

    def _rx_loop(self) -> None:
        buf = ctypes.create_string_buffer(DEFAULT_BUFLEN)
        nread = ctypes.c_int(0)
        while not self._stop.is_set():
            r = _LIB.rtlsdr_read_sync(self.dev, buf, DEFAULT_BUFLEN, ctypes.byref(nread))
            if r != 0:
                self.state = InputState.FAILED
                return
            self.ring.append(buf.raw[: nread.value])

    def stop(self) -> None:
        super().stop()
        if self.dev:
            _LIB.rtlsdr_close(self.dev)
            self.dev = ctypes.c_void_p()


INPUT_CLASS = RtlSdrInput
