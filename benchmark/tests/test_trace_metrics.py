"""The readers of the program's spans and counters (``program_trace.py``
and the five ``metrics/`` files that use it): nothing to read gives None,
and a recorder's records inside the window give the right values."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, program_trace

READERS = ("copy_wait_ms", "dequant_ms", "scatter_ms", "sink_us_per_open", "app_build_s")
S = 1_000_000_000  # nanoseconds a second


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def context(window_start_s=100.0, window_s=10.0, blocks=4, traced=True):
    return SimpleNamespace(window_start=window_start_s, blocks_in_window=blocks,
                           trace_result=SimpleNamespace(window_s=window_s) if traced else None)


def rec(name, t0_s, dur_ms, parent=-1, block=None):
    t0 = int(t0_s * S)
    return (name, t0, t0 + int(dur_ms * 1e6), 1, parent, block)


class FakeRecorder:
    """A recorder's two read calls over fixed records and increments."""

    def __init__(self, recs, increments=()):
        self.recs, self.increments = recs, list(increments)

    def records(self):
        return list(self.recs)

    def counters(self, t0_ns=None, t1_ns=None):
        out = {}
        for t, name, n in self.increments:
            if (t0_ns is None or t >= t0_ns) and (t1_ns is None or t <= t1_ns):
                out[name] = out.get(name, 0) + n
        return out


RECORDS = [
    rec("setup.app", 20.0, 15_000.0),  # set-up, before the window
    rec("pipeline.dequant", 99.0, 50.0, block=0),  # before the window: left out
    rec("app.service", 101.0, 300.0),
    rec("pipeline.copy_wait", 101.0, 0.5, parent=2, block=8),
    rec("pipeline.dequant", 101.01, 8.0, parent=2, block=8),
    rec("pipeline.scatter", 101.02, 30.0, parent=2, block=8),
    rec("app.sinks", 101.05, 20.0, parent=2, block=8),
    rec("app.service", 102.0, 300.0),
    rec("pipeline.dequant", 102.01, 4.0, parent=7, block=16),
    rec("pipeline.scatter", 102.02, 50.0, parent=7, block=16),
    rec("app.sinks", 102.05, 30.0, parent=7, block=9),
    rec("pipeline.scatter", 111.0, 99.0, block=99),  # after the window: left out
]
INCREMENTS = [(int(99.5 * S), "app.open_channels", 7), (int(101.06 * S), "app.open_channels", 400),
              (int(102.06 * S), "app.open_channels", 600), (int(111.5 * S), "app.open_channels", 9)]
WANT = {"copy_wait_ms": 0.5 / 4, "dequant_ms": 12.0 / 4, "scatter_ms": 80.0 / 4,
        "sink_us_per_open": 50_000.0 / 1000, "app_build_s": 15.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_value_of_the_windows_records(name, monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, INCREMENTS))
    assert reader(name).read(context()) == pytest.approx(WANT[name], rel=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_with_nothing_to_read(name, monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, INCREMENTS))
    assert reader(name).read(context(traced=False)) is None  # --trace 0, or no device trace (the CPU)
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder([]))
    assert reader(name).read(context()) is None  # nothing recorded
    monkeypatch.undo()
    import rtlsdr_airband_tpu_torch.runtime as runtime

    monkeypatch.setitem(sys.modules, "rtlsdr_airband_tpu_torch.runtime.trace", None)  # a program without the recorder
    monkeypatch.delattr(runtime, "trace", raising=False)
    assert program_trace.recorder() is None
    assert reader(name).read(context()) is None


def test_readers_read_the_programs_recorder():
    """The program's own recorder under a CPU profiler, read through the
    window of a context that covers it."""
    from torch.profiler import ProfilerActivity, profile

    from rtlsdr_airband_tpu_torch.runtime import trace

    trace.reset()
    try:
        with trace.span("setup.app", always=True):
            time.sleep(0.002)
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("app.service"):
                with trace.span("pipeline.dequant", 0):
                    time.sleep(0.004)
                with trace.span("app.sinks", 0):
                    time.sleep(0.002)
                trace.count("app.open_channels", 10)
        ctx = context(window_start_s=start, window_s=time.perf_counter() - start, blocks=2)
        assert reader("dequant_ms").read(ctx) == pytest.approx(2.0, rel=0.5)
        assert 0 < reader("sink_us_per_open").read(ctx) < 2000
        assert reader("app_build_s").read(ctx) == pytest.approx(0.002, rel=1.0)
        assert reader("copy_wait_ms").read(ctx) is None and reader("scatter_ms").read(ctx) is None
    finally:
        trace.reset()


def test_busy_between_is_the_union_of_device_operations_inside_the_interval():
    """``card_ms.app`` reads ``Trace.busy_between``: overlapping operations
    count once, and what lies outside the host interval (shifted by the
    clocks' offset) is cut off."""
    tr = harness.Trace(10.0, 0.0, {}, {}, True, [(100.0, 101.0), (100.5, 102.0), (103.0, 104.0), (109.0, 112.0)], 100.0)
    assert tr.busy_between(0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert tr.busy_between(0.75, 3.5) == pytest.approx(1.25 + 0.5)
    assert tr.busy_between(4.0, 9.0) == 0.0


def test_realtime_x_app_and_card_busy_ms_read_what_the_entry_measured():
    assert reader("realtime_x.app").read(SimpleNamespace(e2e={"realtime_x": 5.5})) == 5.5
    assert reader("realtime_x.app").read(SimpleNamespace(e2e={})) is None
    assert reader("card_busy_ms").read(SimpleNamespace(counters={"card_busy_ms": 7.08})) == 7.08
    assert reader("card_busy_ms").read(SimpleNamespace(counters={})) is None  # untraced, or the CPU
