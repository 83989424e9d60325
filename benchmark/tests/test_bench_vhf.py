"""The whole VHF airband's files (``configs/vhf2280.json``,
``scenes/vhf228.json``, the cell ``vhf2280.app``), the readers of the App's
input (``ingest_ms``, ``ingest_us_per_mb``), and the cell at a small size on
the CPU: correct as the program runs it, not correct with a planted fault,
and failing soon where no block reaches the pipeline (``entries/app_wide.py``).
An f32 stream through the App reads correct too, as the block entry's does."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from benchmark import check, control, faults, harness, program_trace
from benchmark.reference.channel import bin_for_freq, channel_frequencies
from benchmark.tests import bench_tiny as bt
from benchmark.tests.test_trace_metrics import FakeRecorder, context, reader, rec, S

CELL = "vhf2280.app"


def small_files(channels: int = 8):
    """The cell at ``channels`` channels, one carrier in ten (at least one),
    every channel checked."""
    workload, config, scene = bt.tiny_files(CELL)
    config["channels"]["count"] = channels
    workload["check"]["channels"] = channels
    scene["carriers"] = max(1, channels // 10)
    return workload, config, scene


def run_small(files, seed: int):
    # three seconds: the window has to hold two chunks on a loaded CPU
    ctx = harness.Context(CELL, files[0], files[1], files[2], seed, 3.0, False, torch.device("cpu"), harness.process_start())
    harness.load_module(harness.HERE / "entries" / f"{files[0]['entry']}.py", "benchmark_entry_app_wide").run(ctx)
    return ctx


@pytest.fixture
def host_kernel():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with bt.host_kernel():
        yield
    torch.set_num_threads(threads)


def test_files_load_and_name_each_other():
    bench = bt.load_bench()
    w = bt.load(f"workloads/{CELL}.json")
    cfg, scene = bt.load(f"configs/{w['config']}.json"), bt.load(f"scenes/{w['scene']}.json")
    assert (w["config"], w["entry"], w["scene"]) == ("vhf2280", "app_wide", "vhf228")
    assert cfg["name"] == "vhf2280" and cfg["reduced"] == [] and cfg["sample_format"] == "s8"
    assert (cfg["sample_rate"], cfg["fft_size"], cfg["wave_rate"]) == (20_000_000, 8192, 16000)
    assert scene["carriers"] == cfg["channels"]["count"] // 10
    entry = next(x for x in bench["workloads"] if x["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("vhf2280", "app", 1)
    ports = {c: bt.load(f"configs/{c}.json")["app"]["udp_base_port"] for c in ("am8192", "vhf2280")}
    assert ports["vhf2280"] >= ports["am8192"] + 8192 and ports["vhf2280"] + 2280 <= 32768  # below the ephemeral ports


def test_channel_grid_is_the_833_khz_airband_one_to_a_bin():
    cfg = bt.load("configs/vhf2280.json")
    f = channel_frequencies(cfg)
    assert len(f) == 2280 and f[0] == 118_000_000 and f[-1] == 136_991_666
    assert set(np.diff(f).tolist()) == {8333, 8334}
    bins = {bin_for_freq(int(x), cfg["center_freq"], cfg["sample_rate"], cfg["fft_size"]) for x in f}
    assert len(bins) == 2280


def test_every_scene_tone_is_a_voice_tone():
    scene = bt.load("scenes/vhf228.json")
    tones = scene["tone_hz"] + scene["tone_step_hz"] * np.arange(scene["carriers"])
    assert tones.min() >= 300 and tones.max() < 4000


RECORDS = [
    rec("app.ring_read", 99.0, 5.0),  # before the window: left out
    rec("app.service", 101.0, 300.0),
    rec("app.ring_read", 101.0, 1.5, parent=1),
    rec("pipeline.ingest", 101.01, 6.0, parent=1),
    rec("app.service", 102.0, 300.0),
    rec("app.ring_read", 102.0, 2.5, parent=4),
    rec("pipeline.ingest", 102.01, 10.0, parent=4),
    rec("pipeline.ingest", 111.0, 50.0),  # after the window: left out
]
BYTES = [(int(99.0 * S), "pipeline.ingest_bytes", 5_000_000), (int(101.01 * S), "pipeline.ingest_bytes", 5_000_000),
         (int(102.01 * S), "pipeline.ingest_bytes", 5_000_000), (int(111.0 * S), "pipeline.ingest_bytes", 5_000_000)]


@pytest.mark.parametrize("name,want", [("ingest_ms", 20.0 / 4), ("ingest_us_per_mb", 20_000.0 / 10)])
def test_input_readers_read_the_windows_spans(name, want, monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, BYTES))
    assert reader(name).read(context()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["ingest_ms", "ingest_us_per_mb"])
def test_input_readers_give_none_with_nothing_to_read(name, monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS, BYTES))
    assert reader(name).read(context(traced=False)) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder([rec("app.sinks", 101.0, 5.0)], BYTES))  # a program without the input spans
    assert reader(name).read(context()) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    assert reader(name).read(context()) is None


@pytest.mark.parametrize("fault", [None, *faults.KINDS])
def test_small_cell_is_correct_and_a_planted_fault_is_not(fault, host_kernel):
    files = small_files()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        ctx = run_small(files, 2**31 + 83)
    numbers = check.compare_cases(files[1], ctx.cases, files[0]["check"]["limits"])
    assert ctx.attempted > 0 and (fault is not None or ctx.counters["opened"] > 0)
    assert control.verdict(numbers, ctx.failed) is (fault is None), numbers


def test_app_wide_fails_soon_where_no_block_reaches_the_pipeline(host_kernel, monkeypatch):
    """A ring that never holds a block, as a program whose ring was smaller
    than the block had: the entry raises within its stall limit and names
    the ring's and the block's sizes, where the ``app`` entry waits out its
    deadline."""
    from rtlsdr_airband_tpu_torch.inputs.base import Input

    entry = harness.load_module(harness.HERE / "entries" / "app_wide.py", "benchmark_entry_app_wide")
    monkeypatch.setattr(Input, "available_bytes", lambda self: 0)
    monkeypatch.setattr(entry, "STALL_S", 1.0)
    files = small_files()
    ctx = harness.Context(CELL, *files, 2**31 + 89, 1.0, False, torch.device("cpu"), harness.process_start())
    with pytest.raises(RuntimeError, match=r"ring holds 20000000 B, a block is 5000000 B"):
        entry.run(ctx)


def test_app_reads_f32_correctly(host_kernel):
    """The App in f32 (CF32, a USRP-class SDR's format) reads correct, as
    the block entry does."""
    rc, res, err = bt.run("am8192.app", seed=2**31 + 97, sample_format="f32")
    assert rc == 0, err[-2000:]
    assert res["correct"] and res["failed"] == 0, res["checks"]
