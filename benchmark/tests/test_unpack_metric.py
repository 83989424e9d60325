"""The reader of ``unpack_us_per_row``: nothing to read gives None, and the
window's dequant and scatter spans over its unpacked slot rows give the
Framer's cost a channel-block."""

from __future__ import annotations

import pytest

from benchmark import program_trace
from benchmark.tests.test_trace_metrics import RECORDS, FakeRecorder, context, reader, rec, S

ROWS = [(int(99.5 * S), "pipeline.unpacked_rows", 5), (int(101.03 * S), "pipeline.unpacked_rows", 370),
        (int(102.03 * S), "pipeline.unpacked_rows", 380), (int(111.5 * S), "pipeline.unpacked_rows", 9)]


def test_reads_dequant_and_scatter_over_the_windows_rows(monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, ROWS))
    # dequant 8 + 4 ms and scatter 30 + 50 ms inside the window, over 750 rows
    assert reader("unpack_us_per_row").read(context()) == pytest.approx(92_000.0 / 750, rel=1e-6)


def test_reads_none_without_the_counter_or_the_spans(monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS))  # a program without the counter
    assert reader("unpack_us_per_row").read(context()) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder([rec("app.sinks", 101.0, 5.0)], ROWS))
    assert reader("unpack_us_per_row").read(context()) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, ROWS))
    assert reader("unpack_us_per_row").read(context(traced=False)) is None
