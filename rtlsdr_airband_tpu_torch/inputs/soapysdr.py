"""SoapySDR input driver via the SoapySDR python binding.

Semantic model of the reference driver (reference: src/input-soapysdr.cpp):
device from an args string, native-format negotiation preferring CU8/CS8
over CS16/CF32 (input-soapysdr.cpp:39-109), nearest sample rate from the
device's ranges (:111-146), per-element gains / AGC / antenna selection
(:217-274), and a blocking readStream loop (:276-320).  Gated on the
``SoapySDR`` python module; ``init()`` raises when absent.
"""

from __future__ import annotations

import numpy as np

from .base import Input, InputState

_FORMAT_PREFERENCE = ["CU8", "CS8", "CS16", "CF32"]  # :39-109 ordering
_FORMAT_MAP = {"CU8": ("u8", 2, 127.5), "CS8": ("s8", 2, 127.5), "CS16": ("s16", 4, 32768.0), "CF32": ("f32", 8, 1.0)}


def soapysdr_available() -> bool:
    try:
        import SoapySDR  # noqa: F401

        return True
    except ImportError:
        return False


class SoapySdrInput(Input):
    def __init__(
        self,
        device_string: str = "",
        sample_rate: int = 2_560_000,
        centerfreq: int = 0,
        gain: float | str | None = None,
        correction: float = 0.0,
        agc: bool = False,
        antenna: str | None = None,
        channel: int = 0,
        buf_size: int = 10 * 320_000,
        extra: int = 0,
    ):
        super().__init__(sample_rate, centerfreq, buf_size=buf_size, extra=extra)
        self.device_string = device_string
        self.gain = gain
        self.correction = correction
        self.agc = agc
        self.antenna = antenna
        self.channel = channel
        self.sdr = None
        self.stream = None

    def init(self) -> None:
        try:
            import SoapySDR
            from SoapySDR import SOAPY_SDR_RX
        except ImportError as e:
            self.state = InputState.FAILED
            raise RuntimeError("SoapySDR python module not found") from e

        self.sdr = SoapySDR.Device(self.device_string)
        ch = self.channel

        # native-format negotiation (reference: input-soapysdr.cpp:39-109)
        native = set(self.sdr.getStreamFormats(SOAPY_SDR_RX, ch))
        fmt = next((f for f in _FORMAT_PREFERENCE if f in native), "CF32")
        self.sample_format, self.bytes_per_sample, self.fullscale = _FORMAT_MAP[fmt]
        self._soapy_format = fmt

        # nearest supported sample rate (:111-146)
        rates = []
        for r in self.sdr.listSampleRates(SOAPY_SDR_RX, ch) or []:
            rates.append(float(r))
        if rates:
            self.sample_rate = int(min(rates, key=lambda r: abs(r - self.sample_rate)))
        self.sdr.setSampleRate(SOAPY_SDR_RX, ch, float(self.sample_rate))
        self.sdr.setFrequency(SOAPY_SDR_RX, ch, float(self.centerfreq))
        if self.correction:
            self.sdr.setFrequencyCorrection(SOAPY_SDR_RX, ch, float(self.correction))
        if self.antenna:
            self.sdr.setAntenna(SOAPY_SDR_RX, ch, self.antenna)
        if self.agc:
            self.sdr.setGainMode(SOAPY_SDR_RX, ch, True)
        elif isinstance(self.gain, (int, float)):
            self.sdr.setGain(SOAPY_SDR_RX, ch, float(self.gain))
        elif isinstance(self.gain, str):
            # per-element "name1=db1,name2=db2" list (:217-250)
            for part in self.gain.split(","):
                name, val = part.split("=")
                self.sdr.setGain(SOAPY_SDR_RX, ch, name.strip(), float(val))
        self.state = InputState.INITIALIZED

    def set_centerfreq(self, freq: int) -> bool:
        from SoapySDR import SOAPY_SDR_RX

        self.centerfreq = freq
        self.sdr.setFrequency(SOAPY_SDR_RX, self.channel, float(freq))
        return True

    def _rx_loop(self) -> None:
        import SoapySDR
        from SoapySDR import SOAPY_SDR_RX

        fmt = self._soapy_format
        elem_dtype = {"CU8": np.uint8, "CS8": np.int8, "CS16": np.int16, "CF32": np.float32}[fmt]
        n_elems = 65536
        buf = np.empty(2 * n_elems, elem_dtype)
        self.stream = self.sdr.setupStream(SOAPY_SDR_RX, fmt, [self.channel])
        self.sdr.activateStream(self.stream)
        try:
            while not self._stop.is_set():
                sr = self.sdr.readStream(self.stream, [buf], n_elems)
                if sr.ret > 0:
                    self.ring.append(buf[: 2 * sr.ret].view(np.uint8).copy())
                elif sr.ret < 0 and sr.ret != -1:  # -1 = SOAPY_SDR_TIMEOUT
                    self.state = InputState.FAILED
                    return
        finally:
            self.sdr.deactivateStream(self.stream)
            self.sdr.closeStream(self.stream)


INPUT_CLASS = SoapySdrInput
