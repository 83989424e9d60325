"""File IQ input driver (reference: src/input-file.cpp).

Reads raw IQ from a file in the configured sample format, pacing itself to
``speedup_factor`` × real time (reference default 4, input-file.cpp:94) by
computing the wall-time cost per byte and sleeping off any surplus
(input-file.cpp:127-142).  EOF drives the state to FAILED, matching the
reference's session-ending semantics (input-file.cpp:104-108); set
``speedup_factor=0`` for unpaced batch processing (process as fast as the
pipeline drains).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..ops.sampleconv import SampleFormat, default_fullscale
from .base import Input, InputState

_BYTES_PER_SAMPLE = {"u8": 2, "s8": 2, "s16": 4, "f32": 8}

CHUNK = 256 * 1024


class FileInput(Input):
    def __init__(
        self,
        filepath: str,
        sample_rate: int = 2_560_000,
        centerfreq: int = 0,
        sample_format: str = "u8",
        speedup_factor: float = 4.0,
        fullscale: float | None = None,
        buf_size: int = 10 * 320_000,
        extra: int = 0,
    ):
        super().__init__(sample_rate, centerfreq, buf_size=buf_size, extra=extra)
        self.filepath = filepath
        self.sample_format = sample_format
        self.bytes_per_sample = _BYTES_PER_SAMPLE[sample_format]
        self.fullscale = fullscale if fullscale is not None else default_fullscale(SampleFormat(sample_format))
        self.speedup_factor = speedup_factor
        self._f = None
        self._native = None

    def init(self) -> None:
        if not os.path.exists(self.filepath):
            self.state = InputState.FAILED
            raise FileNotFoundError(self.filepath)
        # prefer the C++ reader thread (native/ingest.cpp) — no GIL
        # contention with the block loop
        try:
            from ..native import NativeFileReader, NativeRingBuffer, native_available

            if native_available() and isinstance(self.ring, NativeRingBuffer):
                self._native = NativeFileReader(
                    self.filepath, self.ring,
                    bytes_per_sec=self.sample_rate * self.bytes_per_sample,
                    speedup=self.speedup_factor,
                    chunk=CHUNK,
                )
        except FileNotFoundError:
            self.state = InputState.FAILED
            raise
        except Exception:
            self._native = None
        if self._native is None:
            self._f = open(self.filepath, "rb")
        self.state = InputState.INITIALIZED

    def start(self) -> None:
        if self._native is not None:
            self._native.start()
            self.state = InputState.RUNNING
        else:
            super().start()

    @property
    def state(self) -> InputState:
        if getattr(self, "_native", None) is not None and self._state in (InputState.RUNNING, InputState.INITIALIZED):
            ns = self._native.state
            if ns == "FAILED":
                return InputState.FAILED
            if ns == "STOPPED":
                return InputState.STOPPED
        return self._state

    @state.setter
    def state(self, v: InputState) -> None:
        self._state = v

    def _rx_loop(self) -> None:
        # wall time represented by one byte of input (input-file.cpp:94)
        if self.speedup_factor > 0:
            time_per_byte = 1.0 / (self.sample_rate * self.bytes_per_sample * self.speedup_factor)
        else:
            time_per_byte = 0.0
        while not self._stop.is_set():
            t0 = time.monotonic()
            data = self._f.read(CHUNK)
            if not data:
                self.state = InputState.FAILED  # EOF (input-file.cpp:104-108)
                return
            while not self.ring.append(data):
                if self._stop.is_set():
                    return
                time.sleep(0.005)  # backpressure instead of drop for file source
            if time_per_byte:
                surplus = len(data) * time_per_byte - (time.monotonic() - t0)
                if surplus > 0:
                    time.sleep(surplus)
        # loop exited via stop
    def stop(self) -> None:
        if self._native is not None:
            self._native.stop()
            if self._native.state == "FAILED":
                self._state = InputState.FAILED
            elif self._state == InputState.RUNNING:
                self._state = InputState.STOPPED
        else:
            super().stop()
        if self._f is not None:
            self._f.close()
            self._f = None


INPUT_CLASS = FileInput
