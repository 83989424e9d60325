"""Input driver abstraction + ring buffer.

Models the reference's input layer (reference: src/input-common.h:31-64,
input-common.cpp): an ``Input`` has a lifecycle state machine
(UNKNOWN -> INITIALIZED -> RUNNING -> FAILED/STOPPED/DISABLED), a sample
format, and produces raw IQ bytes into a ring buffer.  Drivers are
discovered by module name — ``input_new("rtlsdr")`` imports
the package's own ``inputs.rtlsdr`` and instantiates its ``INPUT_CLASS``
(the analog of the reference's ``dlsym(NULL, "<type>_input_new")``,
input-common.cpp:35-54).

The ring buffer keeps the reference's key trick — tail duplication
(input-helpers.cpp:27-54): capacity is extended by ``extra`` bytes and the
head is mirrored past the end on wrap, so one FFT window never straddles
the wrap point and consumers always read contiguous memory.
"""

from __future__ import annotations

import importlib
import threading
from enum import Enum

import numpy as np


class InputState(Enum):
    UNKNOWN = 0
    INITIALIZED = 1
    RUNNING = 2
    FAILED = 3
    STOPPED = 4
    DISABLED = 5


class RingBuffer:
    """Byte ring buffer with tail duplication + overflow counting
    (reference: input-helpers.cpp:27-63)."""

    def __init__(self, size: int, extra: int = 0):
        self.size = size
        self.extra = extra
        self.buf = np.zeros(size + extra, np.uint8)
        self.head = 0  # write position (bufe)
        self.tail = 0  # read position (bufs)
        self.used = 0
        self.overflow_count = 0
        self.lock = threading.Lock()

    def append(self, data: np.ndarray) -> bool:
        data = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
        n = data.size
        with self.lock:
            if self.used + n > self.size:
                self.overflow_count += 1
                return False
            end = self.head + n
            if end <= self.size:
                self.buf[self.head : end] = data
                # tail duplication: mirror the first `extra` bytes past the end
                if self.head < self.extra:
                    dup = min(self.extra - self.head, n)
                    self.buf[self.size + self.head : self.size + self.head + dup] = data[:dup]
            else:
                first = self.size - self.head
                self.buf[self.head : self.size] = data[:first]
                rest = n - first
                self.buf[:rest] = data[first:]
                # mirror new head region into the duplicated tail
                dup = min(self.extra, rest)
                self.buf[self.size : self.size + dup] = self.buf[:dup]
            self.head = end % self.size
            self.used += n
            return True

    def available(self) -> int:
        with self.lock:
            return self.used

    def read(self, n: int) -> np.ndarray | None:
        """Consume n bytes; returns a contiguous view copy (tail duplication
        guarantees contiguity as long as n <= size is respected)."""
        with self.lock:
            if self.used < n:
                return None
            if self.tail + n <= self.size + self.extra:
                out = self.buf[self.tail : self.tail + n].copy()
            else:
                out = np.concatenate([self.buf[self.tail : self.size], self.buf[: (self.tail + n) % self.size]])
            self.tail = (self.tail + n) % self.size
            self.used -= n
            return out


def make_ring_buffer(size: int, extra: int = 0):
    """Native C++ ring buffer when built (native/ingest.cpp via make), else
    the pure-Python implementation above — identical interfaces."""
    try:
        from ..native import NativeRingBuffer, native_available

        if native_available():
            return NativeRingBuffer(size, extra)
    except Exception:
        pass
    return RingBuffer(size, extra)


class Input:
    """Base driver.  Subclasses implement _rx_loop (thread body pushing into
    self.ring) or override read_nonblock for pull-style sources."""

    sample_format: str = "u8"
    bytes_per_sample: int = 2  # per complex sample (I+Q)
    fullscale: float = 127.5

    def __init__(self, sample_rate: int, centerfreq: int, buf_size: int = 10 * 320_000, extra: int = 0):
        self.sample_rate = sample_rate
        self.centerfreq = centerfreq
        self.state = InputState.UNKNOWN
        self.ring = make_ring_buffer(buf_size, extra)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # lifecycle (reference: input-common.cpp:56-84)
    def init(self) -> None:
        self.state = InputState.INITIALIZED

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._rx_thread, daemon=True)
        self._thread.start()

    def _rx_thread(self) -> None:
        self.state = InputState.RUNNING
        try:
            self._rx_loop()
            if self.state == InputState.RUNNING:
                self.state = InputState.STOPPED
        except Exception:
            self.state = InputState.FAILED

    def _rx_loop(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.state == InputState.RUNNING:
            self.state = InputState.STOPPED

    def set_centerfreq(self, freq: int) -> bool:
        """Retune (scan mode).  Drivers with hardware override this."""
        self.centerfreq = freq
        return True

    def read_bytes(self, n: int) -> np.ndarray | None:
        return self.ring.read(n)

    def available_bytes(self) -> int:
        return self.ring.available()


_DRIVER_ALIASES = {"file": "filesrc"}


def input_new(typ: str, **kwargs) -> Input:
    """Driver factory by type name (reference: input_new, input-common.cpp:35-54)."""
    mod_name = _DRIVER_ALIASES.get(typ, typ)
    try:
        mod = importlib.import_module(f"{__package__}.{mod_name}")
    except ImportError as e:
        raise ValueError(f"unknown input type {typ!r}: {e}") from e
    cls = getattr(mod, "INPUT_CLASS", None)
    if cls is None:
        raise ValueError(f"input module {mod_name!r} exports no INPUT_CLASS")
    return cls(**kwargs)
