"""The port's recorder (``runtime/trace.py``) on the CPU: off without a
profiler, the Pipeline's and the App's spans and counters under one, their
nesting, set-up spans without one, the record cap, and ``--profile``'s
Chrome trace holding the program's spans beside the profiler's.

The demod runs as K1's host build, as in the other Pipeline tests.
"""

import json
import os
import socket
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import cli
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.runtime import trace
from rtlsdr_airband_tpu_torch.runtime.config import load_config, loads_config
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from torch_port_common import CENTER, FS, SCENE_SPECS, drive_app, scene_u8, write_am_u8

CHUNK = 2
PIPELINE_SPANS = ("pipeline.ingest", "pipeline.dispatch", "pipeline.stage", "pipeline.launch", "pipeline.fetch_start",
                  "pipeline.copy_wait", "pipeline.dequant", "pipeline.scatter", "pipeline.fade")
STEP = 400_000  # bytes a feed


@pytest.fixture(autouse=True)
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    trace.reset()
    yield
    trace.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def small_pipeline() -> Pipeline:
    """Chunks of two blocks, one in flight, the App cell's fetch economy
    (slots, block-float audio, fade tails synthesized on the host)."""
    cfg = PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="u8", fullscale=127.5,
                         chunk_blocks=CHUNK, async_depth=1, active_slots=2, fetch_audio_fmt="i8bf",
                         suppress_fade_tails=True, fetch_meta_per_chunk=True, device="cpu")
    return Pipeline(cfg, [ChannelSpec(**k) for k in SCENE_SPECS])


def feed(p: Pipeline, raw: bytes, between=None) -> int:
    """Feed ``raw`` in steps and flush; ``between()`` runs after every
    yielded block.  Returns the blocks yielded."""
    n = 0
    for gen in [p.feed(raw[i : i + STEP]) for i in range(0, len(raw), STEP)] + [p.flush()]:
        for _ in gen:
            n += 1
            if between is not None:
                between()
    return n


def named(recs, name):
    return [r for r in recs if r[0] == name]


def test_nothing_records_without_a_profiler():
    p = small_pipeline()
    assert feed(p, scene_u8(secs=1.0)) > 0
    assert trace.records() == [] and trace.counters() == {}


def test_pipeline_spans_under_a_profiler():
    p = small_pipeline()
    raw = scene_u8(secs=1.0)
    with cpu_profile():
        n = feed(p, raw)
    recs = trace.records()
    assert {r[0] for r in recs} == set(PIPELINE_SPANS)
    assert len(named(recs, "pipeline.ingest")) == -(-len(raw) // STEP)  # one a feed
    chunks = list(range(0, p.blocks_processed, CHUNK))
    for name in ("pipeline.dispatch", "pipeline.stage", "pipeline.launch", "pipeline.fetch_start",
                 "pipeline.copy_wait"):
        assert [r[5] for r in named(recs, name)] == chunks, name
    # active-gather mode restores each block's slots in a dequant span of its own
    for name in ("pipeline.dequant", "pipeline.scatter", "pipeline.fade"):
        assert [r[5] for r in named(recs, name)] == list(range(n)) == list(range(p.blocks_processed)), name
    for r in recs:
        parent = recs[r[4]][0] if r[4] >= 0 else None
        want = {"pipeline.stage": "pipeline.dispatch", "pipeline.launch": "pipeline.dispatch",
                "pipeline.fetch_start": "pipeline.dispatch", "pipeline.fade": "pipeline.scatter"}.get(r[0])
        assert parent == want, (r, parent)
    assert set(trace.counters()) == {"pipeline.unpacked_rows", "pipeline.ingest_bytes"}
    assert trace.counters()["pipeline.ingest_bytes"] == len(raw)


def test_unpacked_rows_count_the_valid_slots():
    """``pipeline.unpacked_rows`` adds each block's valid slots (the rows
    restored and copied) under a recording, and nothing without one."""
    fetched = []
    start = Pipeline._start_fetch

    def counting(self, outs):
        fetched.append(int((outs["slot_channel"] >= 0).sum()))
        return start(self, outs)

    for recording in (True, False):
        trace.reset()
        fetched.clear()
        p = small_pipeline()
        p._start_fetch = counting.__get__(p)
        if recording:
            with cpu_profile():
                feed(p, scene_u8(secs=1.0))
            assert trace.counters()["pipeline.unpacked_rows"] == sum(fetched) and sum(fetched) > 0
        else:
            feed(p, scene_u8(secs=1.0))
            assert "pipeline.unpacked_rows" not in trace.counters() and sum(fetched) > 0


def test_parents_nest_and_self_time_is_duration_less_children():
    p = small_pipeline()
    with cpu_profile():
        feed(p, scene_u8(secs=1.0))
    recs = trace.records()
    selfs = trace.self_ns(recs)
    kids = {}
    for i, r in enumerate(recs):
        if r[4] >= 0:
            parent = recs[r[4]]
            assert r[4] < i and parent[1] <= r[1] <= r[2] <= parent[2] and parent[3] == r[3]
            kids.setdefault(r[4], []).append(r)
    assert kids
    for i, r in enumerate(recs):
        assert selfs[i] == (r[2] - r[1]) - sum(k[2] - k[1] for k in kids.get(i, ())) >= 0


def test_no_pipeline_span_holds_the_consumers_time():
    p = small_pipeline()
    sleeps = []

    def consumer():
        t0 = time.perf_counter_ns()
        time.sleep(0.02)
        sleeps.append((t0, time.perf_counter_ns()))

    with cpu_profile():
        feed(p, scene_u8(secs=1.0), between=consumer)
    recs = [r for r in trace.records() if r[0].startswith("pipeline.")]
    assert sleeps and recs
    for s0, s1 in sleeps:
        assert not [r for r in recs if r[1] < s1 and s0 < r[2]], "a pipeline span overlaps the consumer's sleep"


def udp_sink_config(iq, port: int) -> str:
    return f'''
fft_size = 512;
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: (
    {{ freq = 120.4; outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} ); }},
    {{ freq = 120.7; outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} ); }}
  );
}});
'''


@pytest.fixture
def udp_port():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    yield rx.getsockname()[1]
    rx.close()


def test_app_fast_path_records_a_handler_a_block(tmp_path, udp_port):
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5, gate=(0.2, 0.75))
    app = App(loads_config(udp_sink_config(iq, udp_port)), device="cpu")
    rt = app.devices[0]
    assert rt.fast_path
    opened = []
    fast = app._handle_block_fast

    def counted(rt, out):
        opened.append(int(np.count_nonzero(out["active"])))
        fast(rt, out)

    app._handle_block_fast = counted
    with cpu_profile():
        drive_app(app)
    recs = trace.records()
    handlers = named(recs, "app.handler")
    assert [r[5] for r in handlers] == list(range(rt.pipeline.blocks_processed)) and len(handlers) == len(opened)
    assert sum(opened) > 0 and trace.counters()["app.open_channels"] == sum(opened)
    for name in ("app.gather", "app.sinks"):
        assert [recs[r[4]][0] for r in named(recs, name)] == ["app.handler"] * len(handlers), name
    # a pass of the service loop holds its blocks' handling; the drain when the
    # input ends runs in the round that found it ended, stop()'s outside any
    parents = [recs[r[4]][0] for r in handlers if r[4] >= 0]
    assert "app.service" in parents and set(parents) <= {"app.service", "app.round"}


def test_app_input_spans_and_bytes_under_a_profiler(tmp_path, udp_port):
    """A pass of the service loop reads a block's bytes from the ring under
    ``app.ring_read``, and ``Pipeline.feed`` appends them under
    ``pipeline.ingest``, both inside ``app.service``; ``pipeline.ingest_bytes``
    adds up every byte read from the ring (the stream's tail too)."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5, gate=(0.2, 0.75))
    app = App(loads_config(udp_sink_config(iq, udp_port)), device="cpu")
    rt = app.devices[0]
    reads = []
    read = rt.input.read_bytes

    def counted(n):
        out = read(n)
        reads.append(0 if out is None else out.nbytes)
        return out

    rt.input.read_bytes = counted
    with cpu_profile():
        drive_app(app)
    recs = trace.records()
    ring_reads, ingests = named(recs, "app.ring_read"), named(recs, "pipeline.ingest")
    assert len(ring_reads) >= 2 and all(recs[r[4]][0] == "app.service" for r in ring_reads)
    assert all(r[4] < 0 or recs[r[4]][0] == "app.service" for r in ingests)
    assert len(ingests) == len(reads) and sum(r[4] >= 0 for r in ingests) == len(ring_reads)
    assert trace.counters()["pipeline.ingest_bytes"] == sum(reads) == os.path.getsize(iq)


def test_recorded_names_are_in_the_recorders_list(tmp_path, udp_port):
    """Every span and counter the App and its Pipeline record is in the list
    of names in ``runtime/trace.py``'s docstring."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5, gate=(0.2, 0.75))
    with cpu_profile():
        app = App(loads_config(udp_sink_config(iq, udp_port)), device="cpu")
        app.devices[0].pipeline.warm()
        drive_app(app)
    names = {r[0] for r in trace.records()} | set(trace.counters())
    assert {"app.ring_read", "pipeline.ingest", "pipeline.ingest_bytes", "setup.app"} <= names
    assert [n for n in sorted(names) if f"``{n}``" not in trace.__doc__] == []


def test_set_up_spans_record_without_a_profiler(tmp_path, udp_port):
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.0)
    conf = tmp_path / "app.conf"
    conf.write_text(udp_sink_config(iq, udp_port))
    app = App(load_config(str(conf)), device="cpu")
    app.devices[0].pipeline.warm()
    drive_app(app)
    assert app.devices[0].pipeline.blocks_processed > 0
    recs = trace.records()
    names = [r[0] for r in recs]
    assert all(n.startswith("setup.") for n in names), names
    assert {"setup.app", "setup.pipeline", "setup.input", "setup.warm"} <= set(names)
    for name in ("setup.pipeline", "setup.input"):
        assert [recs[r[4]][0] for r in named(recs, name)] == ["setup.app"], name
    assert trace.counters() == {}


def test_warm_builds_the_kernel_library_inside_its_own_span(monkeypatch):
    """Where the card's kernel library is still to be built, ``warm`` builds
    it first, under ``setup.library`` inside ``setup.warm``; once it is
    loaded, no such span opens."""
    built = []
    monkeypatch.setattr(demod_cuda, "cuda_library", lambda: built.append(time.perf_counter_ns()))
    monkeypatch.setattr(Pipeline, "_needs_library", lambda self: not built)
    p = small_pipeline()
    p.warm()
    p.warm()
    recs = trace.records()
    assert [r[0] for r in recs] == ["setup.warm", "setup.library", "setup.warm"]
    assert recs[1][4] == 0 and recs[1][1] <= built[0] <= recs[1][2] and len(built) == 1


def test_records_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 5)
    for i in range(8):
        with trace.span("setup.test", i, always=True):
            pass
    assert [r[5] for r in trace.records()] == [0, 1, 2, 3, 4]
    assert trace.counters()["trace.dropped"] == 3


def test_counters_sum_inside_a_window():
    with cpu_profile():
        trace.count("test.n", 2)
        t = time.perf_counter_ns()
        trace.count("test.n", 3)
        trace.count("test.m")
    trace.count("test.n", 100)  # the profiler has stopped: not counted
    assert trace.counters() == {"test.n": 5, "test.m": 1}
    assert trace.counters(t, time.perf_counter_ns()) == {"test.n": 3, "test.m": 1}


def test_profile_trace_holds_the_program_spans_aligned(tmp_path):
    """``--profile DIR``'s file: a program span and a profiler range around
    the same 10 ms sleep start and end within 2 ms of each other."""
    with cpu_profile() as prof:
        with trace.span("test.sleep", 7), record_function("test.sleep.range"):
            time.sleep(0.01)
    path = cli.write_profile(prof, str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    (mine,) = [e for e in events if e.get("name") == "test.sleep"]
    (theirs,) = [e for e in events if e.get("name") == "test.sleep.range"]
    assert mine["pid"] == trace.CHROME_PID and mine["args"]["block"] == 7
    assert abs(mine["ts"] - theirs["ts"]) < 2000 and abs(mine["dur"] - theirs["dur"]) < 2000
    assert mine["dur"] >= 10_000
    assert {"ph": "M", "name": "process_name", "pid": trace.CHROME_PID, "args": {"name": "program spans"}} in events
