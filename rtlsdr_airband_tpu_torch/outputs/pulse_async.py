"""PulseAudio sink over the ASYNC (threaded-mainloop) API via ctypes —
the reference's model (src/pulse.cpp): one shared pa_threaded_mainloop, a
pa_context per output, and per-output playback streams created CORKED; for
stereo, TWO mono streams (FRONT_LEFT / FRONT_RIGHT channel maps) where the
right stream is connected with the left as its sync master
(pa_stream_connect_playback sync_stream arg, pulse.cpp:94-146) and the pair
is uncorked only once BOTH are ready (stream_state_cb, pulse.cpp:73-92) — so
the two channels can never start misaligned.  Writes check the master
stream's latency against the 10 s cap (PULSE_STREAM_LATENCY_LIMIT,
rtl_airband.h:392; pulse.cpp:213-223) and disconnect on overrun or write
failure; the app's 10 s output check calls :meth:`reconnect`
(output.cpp:936-1005 analog).

``libpulse.so.0`` is loaded lazily; when absent the caller falls back to the
simple-API sink (outputs/pulse.py) or drops the output.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

from ..logutil import LOG_INFO, LOG_WARNING, log

PA_CONTEXT_READY = 4
PA_CONTEXT_FAILED = 5
PA_CONTEXT_TERMINATED = 6
PA_STREAM_READY = 2
PA_STREAM_FAILED = 3
PA_STREAM_TERMINATED = 4
PA_SAMPLE_FLOAT32LE = 5
PA_SEEK_RELATIVE = 0
# PA_STREAM_START_CORKED | INTERPOLATE_TIMING | AUTO_TIMING_UPDATE | ADJUST_LATENCY
PA_STREAM_FLAGS = 0x0001 | 0x0002 | 0x0008 | 0x2000
PA_CHANNEL_POSITION_MONO = 0
PA_CHANNEL_POSITION_FRONT_LEFT = 1
PA_CHANNEL_POSITION_FRONT_RIGHT = 2
PA_CHANNELS_MAX = 32
LATENCY_LIMIT_USEC = 10_000_000  # reference: rtl_airband.h:392 (10 s)


class _SampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32), ("channels", ctypes.c_uint8)]


class _ChannelMap(ctypes.Structure):
    _fields_ = [("channels", ctypes.c_uint8), ("map", ctypes.c_int * PA_CHANNELS_MAX)]


_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)


def _load():
    name = ctypes.util.find_library("pulse") or "libpulse.so.0"
    try:
        return ctypes.CDLL(name)
    except OSError:
        return None


_LIB = _load()
_mainloop = None
_mainloop_lock = threading.Lock()


def _loop():
    """Shared threaded mainloop, started on first use (pulse.cpp:170-203)."""
    global _mainloop
    with _mainloop_lock:
        if _mainloop is None:
            _LIB.pa_threaded_mainloop_new.restype = ctypes.c_void_p
            _LIB.pa_threaded_mainloop_get_api.restype = ctypes.c_void_p
            ml = _LIB.pa_threaded_mainloop_new()
            if not ml:
                raise OSError("pa_threaded_mainloop_new failed")
            _LIB.pa_threaded_mainloop_start(ctypes.c_void_p(ml))
            _mainloop = ml
    return _mainloop


class _Lock:
    def __enter__(self):
        _LIB.pa_threaded_mainloop_lock(ctypes.c_void_p(_loop()))

    def __exit__(self, *exc):
        _LIB.pa_threaded_mainloop_unlock(ctypes.c_void_p(_loop()))


def available() -> bool:
    return _LIB is not None


class PulseAsyncOutput:
    """Corked, synchronized playback stream(s) on the shared mainloop."""

    def __init__(self, sample_rate: int, stereo: bool = False, server: str | None = None, sink: str | None = None, stream_name: str = "rtlsdr-airband-tpu", continuous: bool = False):
        self.available = _LIB is not None
        self.sample_rate = sample_rate
        self.stereo = stereo
        self.server = server
        self.sink = sink
        self.stream_name = stream_name
        self.continuous = continuous
        self.context = None
        self.left = None
        self.right = None
        self.underflows = 0
        self.overflows = 0
        # ctypes callback objects MUST outlive the C registrations
        self._ctx_cb = _CB(self._on_ctx_state)
        self._stream_cb = _CB(self._on_stream_state)
        self._under_cb = _CB(self._on_underflow)
        self._over_cb = _CB(self._on_overflow)
        if self.available:
            self._connect()

    # ---------------------------------------------------------- setup

    def _connect(self) -> None:
        _LIB.pa_context_new.restype = ctypes.c_void_p
        api = _LIB.pa_threaded_mainloop_get_api(ctypes.c_void_p(_loop()))
        with _Lock():
            self.context = _LIB.pa_context_new(ctypes.c_void_p(api), b"rtlsdr-airband-tpu")
            if not self.context:
                self.available = False
                return
            _LIB.pa_context_set_state_callback(ctypes.c_void_p(self.context), self._ctx_cb, None)
            if _LIB.pa_context_connect(ctypes.c_void_p(self.context), self.server.encode() if self.server else None, 0, None) < 0:
                log(LOG_WARNING, f"pulse: {self.server or '(default)'}: connect failed")
                self._teardown_locked()

    def _on_ctx_state(self, ctx, _ud) -> None:
        # called from the mainloop thread WITH the loop lock held
        st = _LIB.pa_context_get_state(ctypes.c_void_p(ctx))
        if st == PA_CONTEXT_READY:
            self._setup_streams_locked()
        elif st in (PA_CONTEXT_FAILED, PA_CONTEXT_TERMINATED):
            log(LOG_WARNING, f"pulse: context {'failed' if st == PA_CONTEXT_FAILED else 'terminated'} for stream {self.stream_name!r}")
            # full teardown, not just nulled streams: reconnect() keys on
            # ``context is None``, so leaving the dead context set would
            # make the output silently dead for the rest of the process
            # (the reference nulls it via pulse_shutdown from
            # pulse_ctx_state_cb for the same reason).  Safe here: this
            # callback runs on the mainloop thread with the loop lock held.
            self._teardown_locked()

    def _setup_streams_locked(self) -> None:
        """pulse.cpp:122-146: mono float32 streams, left first, right synced
        to left, both born corked."""
        pos_l = PA_CHANNEL_POSITION_FRONT_LEFT if self.stereo else PA_CHANNEL_POSITION_MONO
        self.left = self._one_stream_locked(pos_l, sync=None)
        if self.left is None:
            return
        if self.stereo:
            self.right = self._one_stream_locked(PA_CHANNEL_POSITION_FRONT_RIGHT, sync=self.left)
            if self.right is None:
                self.left = None

    def _one_stream_locked(self, position: int, sync):
        ss = _SampleSpec(PA_SAMPLE_FLOAT32LE, self.sample_rate, 1)
        cmap = _ChannelMap()
        cmap.channels = 1
        cmap.map[0] = position
        _LIB.pa_stream_new.restype = ctypes.c_void_p
        stream = _LIB.pa_stream_new(ctypes.c_void_p(self.context), self.stream_name.encode(), ctypes.byref(ss), ctypes.byref(cmap))
        if not stream:
            return None
        _LIB.pa_stream_set_state_callback(ctypes.c_void_p(stream), self._stream_cb, None)
        _LIB.pa_stream_set_underflow_callback(ctypes.c_void_p(stream), self._under_cb, None)
        _LIB.pa_stream_set_overflow_callback(ctypes.c_void_p(stream), self._over_cb, None)
        rc = _LIB.pa_stream_connect_playback(
            ctypes.c_void_p(stream), self.sink.encode() if self.sink else None, None,
            PA_STREAM_FLAGS, None, ctypes.c_void_p(sync) if sync else None,
        )
        if rc < 0:
            return None
        return stream

    def _on_stream_state(self, stream, _ud) -> None:
        st = _LIB.pa_stream_get_state(ctypes.c_void_p(stream))
        if st == PA_STREAM_READY:
            # uncork only when the whole (pair of) stream(s) is ready
            # (pulse.cpp:76-80)
            if self.left is not None and (
                not self.stereo
                or (self.right is not None and _LIB.pa_stream_get_state(ctypes.c_void_p(self.left)) == PA_STREAM_READY and _LIB.pa_stream_get_state(ctypes.c_void_p(self.right)) == PA_STREAM_READY)
            ):
                _LIB.pa_stream_cork(ctypes.c_void_p(self.left), 0, None, None)
        elif st in (PA_STREAM_FAILED, PA_STREAM_TERMINATED):
            log(LOG_WARNING, f"pulse: stream {self.stream_name!r} {'failed' if st == PA_STREAM_FAILED else 'terminated'}")

    def _on_underflow(self, _stream, _ud) -> None:
        self.underflows += 1
        if self.continuous:  # pulse.cpp:62-67: only worth logging when continuous
            log(LOG_INFO, f"pulse: stream {self.stream_name!r}: underflow")

    def _on_overflow(self, _stream, _ud) -> None:
        self.overflows += 1
        log(LOG_INFO, f"pulse: stream {self.stream_name!r}: overflow")

    # ---------------------------------------------------------- write

    def _ready_locked(self) -> bool:
        if self.context is None or _LIB.pa_context_get_state(ctypes.c_void_p(self.context)) != PA_CONTEXT_READY:
            return False
        if self.left is None or _LIB.pa_stream_get_state(ctypes.c_void_p(self.left)) != PA_STREAM_READY:
            return False
        if self.stereo and (self.right is None or _LIB.pa_stream_get_state(ctypes.c_void_p(self.right)) != PA_STREAM_READY):
            return False
        return True

    def _write_one_locked(self, stream, data: bytes, is_master: bool) -> bool:
        """pulse.cpp:204-233: master-latency cap, then a relative-seek write."""
        if is_master:
            usec = ctypes.c_uint64(0)
            neg = ctypes.c_int(0)
            if _LIB.pa_stream_get_latency(ctypes.c_void_p(stream), ctypes.byref(usec), ctypes.byref(neg)) < 0:
                log(LOG_WARNING, f"pulse: stream {self.stream_name!r}: latency query failed, disconnecting")
                return False
            if usec.value > LATENCY_LIMIT_USEC:
                log(LOG_INFO, f"pulse: stream {self.stream_name!r}: exceeded max backlog, disconnecting")
                return False
        if _LIB.pa_stream_write(ctypes.c_void_p(stream), data, len(data), None, ctypes.c_int64(0), PA_SEEK_RELATIVE) < 0:
            log(LOG_WARNING, f"pulse: stream {self.stream_name!r}: write failed, disconnecting")
            return False
        return True

    def write(self, left: np.ndarray, right: np.ndarray | None = None) -> None:
        if not self.available:
            return
        lb = np.clip(np.asarray(left, np.float32), -1, 1).tobytes()
        with _Lock():
            if not self._ready_locked():
                return
            ok = self._write_one_locked(self.left, lb, is_master=True)
            if ok and self.stereo:
                rb = np.clip(np.asarray(right if right is not None else left, np.float32), -1, 1).tobytes()
                ok = self._write_one_locked(self.right, rb, is_master=False)
            if not ok:
                self._teardown_locked()

    # ----------------------------------------------------- lifecycle

    def _teardown_locked(self) -> None:
        for s in (self.left, self.right):
            if s is not None:
                _LIB.pa_stream_disconnect(ctypes.c_void_p(s))
                _LIB.pa_stream_unref(ctypes.c_void_p(s))
        self.left = self.right = None
        if self.context is not None:
            _LIB.pa_context_disconnect(ctypes.c_void_p(self.context))
            _LIB.pa_context_unref(ctypes.c_void_p(self.context))
            self.context = None

    def reconnect(self) -> None:
        """10 s output check (output.cpp:936-1005): rebuild a torn-down
        connection."""
        if not self.available or _LIB is None:
            return
        with _Lock():
            if self.context is not None:
                return
        self._connect()

    def close(self) -> None:
        if not self.available:
            return
        with _Lock():
            self._teardown_locked()
        self.available = False
