"""ctypes binding for the native ingest runtime (native/ingest.cpp).

Provides NativeRingBuffer and NativeFileReader with the same interfaces as
the pure-Python ring buffer in inputs/base.py and the Python file reader in
inputs/filesrc.py.  The library is built on first use with ``g++`` from the
repository's ``native/ingest.cpp``, read in place, into ``_build/`` beside
this file (named by a hash of the source and flags, so an edited source is
rebuilt); ``native_available()`` gates every consumer, so without a
toolchain the pure-Python ring buffer and reader stand in, as in the JAX
package.

The native sample converters are not bound: ``Pipeline`` decodes by
``ops/sampleconv.py`` and on the device only (the native u8 converter
multiplies by 1/127.5 and lands one ulp off the reference's LUT division on
about half the codes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "ingest.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")
_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> Path | None:
    """Compile ingest.cpp unless an up-to-date build exists; None without a
    source or a compiler, or when the build fails."""
    gxx = shutil.which("g++")
    if gxx is None or not _SRC.exists():
        return None
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"ingest-{h}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        r = subprocess.run([gxx, *_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0 or not tmp.exists():
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial library
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        c = ctypes
        lib.ring_new.restype = c.c_void_p
        lib.ring_new.argtypes = [c.c_size_t, c.c_size_t]
        lib.ring_free.argtypes = [c.c_void_p]
        lib.ring_append.restype = c.c_int
        lib.ring_append.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
        lib.ring_available.restype = c.c_size_t
        lib.ring_available.argtypes = [c.c_void_p]
        lib.ring_overflow_count.restype = c.c_uint64
        lib.ring_overflow_count.argtypes = [c.c_void_p]
        lib.ring_read.restype = c.c_int
        lib.ring_read.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
        lib.file_reader_new.restype = c.c_void_p
        lib.file_reader_new.argtypes = [c.c_char_p, c.c_void_p, c.c_double, c.c_double, c.c_size_t]
        lib.file_reader_start.argtypes = [c.c_void_p]
        lib.file_reader_state.restype = c.c_int
        lib.file_reader_state.argtypes = [c.c_void_p]
        lib.file_reader_stop.argtypes = [c.c_void_p]
        lib.file_reader_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeRingBuffer:
    """Same interface as inputs.base.RingBuffer, backed by C++."""

    def __init__(self, size: int, extra: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self._r = lib.ring_new(size, extra)
        self.size = size
        self.extra = extra

    def append(self, data) -> bool:
        buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, np.uint8)
        return bool(self._lib.ring_append(self._r, buf.ctypes.data_as(ctypes.c_void_p), buf.size))

    def available(self) -> int:
        return int(self._lib.ring_available(self._r))

    @property
    def overflow_count(self) -> int:
        return int(self._lib.ring_overflow_count(self._r))

    def read(self, n: int):
        out = np.empty(n, np.uint8)
        if not self._lib.ring_read(self._r, out.ctypes.data_as(ctypes.c_void_p), n):
            return None
        return out

    def __del__(self):
        try:
            if getattr(self, "_r", None):
                self._lib.ring_free(self._r)
                self._r = None
        except Exception:
            pass


class NativeFileReader:
    """Paced file RX thread living entirely in C++ (no GIL contention with
    the block loop)."""

    STATE = {0: "UNKNOWN", 1: "INITIALIZED", 2: "RUNNING", 3: "FAILED", 4: "STOPPED"}

    def __init__(self, path: str, ring: NativeRingBuffer, bytes_per_sec: float, speedup: float, chunk: int = 262144):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self._fr = lib.file_reader_new(path.encode(), ring._r, float(bytes_per_sec), float(speedup), chunk)
        if not self._fr:
            raise FileNotFoundError(path)

    def start(self) -> None:
        self._lib.file_reader_start(self._fr)

    @property
    def state(self) -> str:
        return self.STATE[self._lib.file_reader_state(self._fr)]

    def stop(self) -> None:
        if self._fr:
            self._lib.file_reader_stop(self._fr)

    def __del__(self):
        try:
            if getattr(self, "_fr", None):
                self._lib.file_reader_free(self._fr)
                self._fr = None
        except Exception:
            pass
