"""The program's own spans and counters: where the host's time goes, layer
by layer, on the clock the benchmark's window uses.

    from rtlsdr_airband_tpu_torch.runtime import trace

    with trace.span("pipeline.dequant", block=b0):
        ...
    trace.count("app.open_channels", n_open)

The recorder follows ``torch.profiler``: hot-path spans and counters record
only while a profiler records (``--profile DIR``, the benchmark's ``--trace
1``), and add nothing to its device trace.  Off, ``span`` returns one shared
no-op context (no allocation, no clock read) and ``count`` returns at once.
Set-up spans (``always=True``) run once a process and record always.

Every time is ``time.perf_counter_ns()``.  A thread-local stack gives each
span its parent, so a layer's self time is its span's duration less its
children's (``self_ns``).  Records stay in memory, at most
``MAX_RECORDS`` spans and as many counter increments a process; past that,
new ones are dropped and counted under ``trace.dropped``.

``--profile DIR`` appends ``chrome_events()`` to the profiler's Chrome
trace as a process row of its own, "program spans".

The names, a child under its parent:

- ``app.round`` (a pass of ``App._service_once``'s single loop over every
  device), counter ``app.devices_serviced`` (the devices that handed a
  block to their pipeline in that pass); in it, a device's:
- ``app.service`` (a pass of ``App._service_device``): ``app.ring_read``
  (a block's bytes out of the device's ring), then ``Pipeline.feed``'s;
- ``pipeline.ingest`` (the raw bytes appended to the pending stream, and
  decoded on the host where they ship as float32 pairs), counter
  ``pipeline.ingest_bytes`` (the raw bytes each ``feed`` takes);
- ``pipeline.dispatch``: ``pipeline.stage``, ``pipeline.launch``,
  ``pipeline.fetch_start``;
- ``pipeline.copy_wait``, ``pipeline.dequant``, ``pipeline.scatter``
  (``pipeline.fade``), counter ``pipeline.unpacked_rows``;
- ``app.handler``: ``app.gather``, ``app.sinks``, counter
  ``app.open_channels``;
- set-up: ``setup.app`` (``setup.pipeline``, ``setup.input``),
  ``setup.warm`` (``setup.library``).
"""

from __future__ import annotations

import json
import threading
import time

import torch.autograd.profiler as _profiler

MAX_RECORDS = 1_000_000
CHROME_PID = 1_000_000_000  # the Chrome trace's row of the program's spans: a pid no process or device has
_UNIX_MINUS_PERF_NS = time.time_ns() - time.perf_counter_ns()

_records: list[list] = []  # [name, t0_ns, t1_ns or None, thread id, parent record or None, block]
_counts: dict[str, int] = {}
_count_log: list[tuple[int, str, int]] = []  # (t_ns, name, n) of every increment, for windowed sums
_lock = threading.Lock()
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, block):
        self.rec = [name, 0, None, 0, None, block]

    def __enter__(self):
        rec = self.rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.tid = threading.get_native_id()
        rec[3] = _local.tid
        rec[4] = stack[-1] if stack else None
        stack.append(rec)
        _records.append(rec)
        rec[1] = time.perf_counter_ns()

    def __exit__(self, *exc):
        rec = self.rec
        rec[2] = time.perf_counter_ns()
        _local.stack.pop()
        return False


def _dropped() -> None:
    with _lock:
        _counts["trace.dropped"] = _counts.get("trace.dropped", 0) + 1


def span(name: str, block: int | None = None, *, always: bool = False):
    """A context that records ``name`` over its body, with a block id (a
    chunk's span carries its first block's).  Records while a profiler
    records, or always with ``always``."""
    if not (always or _profiler._is_profiler_enabled):
        return _OFF
    if len(_records) >= MAX_RECORDS:
        _dropped()
        return _OFF
    return _Span(name, block)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    n = int(n)
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if len(_count_log) < MAX_RECORDS:
        _count_log.append((time.perf_counter_ns(), name, n))
    else:
        _dropped()


def records() -> list[tuple]:
    """Every closed span, in the order they opened, as (name, t0_ns, t1_ns,
    thread id, parent's index or -1, block or None)."""
    recs = [r for r in list(_records) if r[2] is not None]
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r[0], r[1], r[2], r[3], -1 if r[4] is None else index.get(id(r[4]), -1), r[5]) for r in recs]


def self_ns(recs: list[tuple]) -> list[int]:
    """Each record's self time: its duration less its children's."""
    out = [r[2] - r[1] for r in recs]
    for r in recs:
        if r[4] >= 0:
            out[r[4]] -= r[2] - r[1]
    return out


def counters(t0_ns: int | None = None, t1_ns: int | None = None) -> dict[str, int]:
    """The counters' totals; with bounds, the sums of the increments made in
    [t0_ns, t1_ns] (``trace.dropped`` is a total only)."""
    if t0_ns is None and t1_ns is None:
        with _lock:
            return dict(_counts)
    lo = t0_ns if t0_ns is not None else 0
    hi = t1_ns if t1_ns is not None else float("inf")
    out: dict[str, int] = {}
    for t, name, n in list(_count_log):
        if lo <= t <= hi:
            out[name] = out.get(name, 0) + n
    return out


def reset() -> None:
    """Forget every record and counter."""
    with _lock:
        _records.clear()
        _counts.clear()
        _count_log.clear()


def chrome_events(base_ns: int = 0) -> list[dict]:
    """The spans as Chrome trace events on a process row of their own,
    "program spans": ``ts`` in microseconds since ``base_ns`` (Unix
    nanoseconds, a profiler trace's ``baseTimeNanoseconds``)."""
    events = [{"ph": "M", "name": "process_name", "pid": CHROME_PID, "args": {"name": "program spans"}}]
    for name, t0, t1, tid, _parent, block in records():
        args = {} if block is None else {"block": block}
        events.append({"ph": "X", "cat": "program", "name": name, "pid": CHROME_PID, "tid": tid,
                       "ts": (t0 + _UNIX_MINUS_PERF_NS - base_ns) / 1e3, "dur": (t1 - t0) / 1e3, "args": args})
    return events


def append_to_chrome_trace(path: str) -> None:
    """Add the spans to a Chrome trace written by ``export_chrome_trace``."""
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(chrome_events(int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
