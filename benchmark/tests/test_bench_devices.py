"""The ten-dongle deployment's files (``configs/rtl10x228.json``,
``scenes/rtl228.json``, the cell ``rtl10x228.app``), the readers of its
per-layer metrics (``demod_ms.devices``, ``k1_roofline_pct.devices``,
``round_ms.devices``), the union that ``card_ms.app`` reads there, and the
cell at a small size on the CPU: correct as the program runs it, not
correct with a planted fault."""

from __future__ import annotations

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, control, faults, harness, program_trace
from benchmark.metrics_common import k1_bound_s
from benchmark.reference.channel import bin_for_freq, channel_frequencies
from benchmark.tests import bench_tiny as bt
from benchmark.tests.test_trace_metrics import FakeRecorder, context, reader, rec, S

CELL = "rtl10x228.app"


def entry():
    return harness.load_module(harness.HERE / "entries" / "app_devices.py", "benchmark_entry_app_devices")


def test_files_load_and_name_each_other():
    bench = bt.load_bench()
    w = bt.load(f"workloads/{CELL}.json")
    cfg, scene = bt.load(f"configs/{w['config']}.json"), bt.load(f"scenes/{w['scene']}.json")
    assert (w["config"], w["entry"], w["scene"]) == ("rtl10x228", "app_devices", "rtl228")
    assert cfg["reduced"] == [] and cfg["sample_format"] == "u8" and cfg["multiple_demod_threads"] is False
    assert (cfg["sample_rate"], cfg["fft_size"], cfg["wave_rate"]) == (2_560_000, 512, 16000)
    assert cfg["app"] == bt.load("configs/am8192.json")["app"]
    assert cfg["dongles"]["count"] == len(cfg["dongles"]["centers"]) == 10
    assert scene["carriers"] * 10 == 230 and scene["carriers"] <= cfg["channels"]["count"] // 10 + 1
    entry_ = next(x for x in bench["workloads"] if x["name"] == CELL)
    assert (entry_["config"], entry_["traffic"], entry_["chips"]) == ("rtl10x228", "app", 1)


def test_ten_dongles_hold_the_833_khz_airband_each_around_its_midpoint():
    """Dongle k's channels are channels 228k to 228k + 227 of the grid
    118 MHz + floor(i * 25 kHz / 3), as vhf2280's, at the offsets the
    configuration gives from its centre; the centre is the midpoint of its
    channels, half a channel from the nearest; each channel has a bin of
    its own, inside 90 % of the rate."""
    cfg = bt.load("configs/rtl10x228.json")
    grid = channel_frequencies(bt.load("configs/vhf2280.json"))
    np.testing.assert_array_equal(grid, 118_000_000 + np.arange(2280) * 25_000 // 3)
    offsets = entry().channel_offsets(cfg)
    for k, c in enumerate(cfg["dongles"]["centers"]):
        f = c + offsets
        np.testing.assert_array_equal(f, grid[228 * k : 228 * (k + 1)])
        assert c == round(118_000_000 + (228 * k + 113.5) * 25_000 / 3)
        assert min(np.abs(f - c)) == 4167
        bins = {bin_for_freq(int(x), c, cfg["sample_rate"], cfg["fft_size"]) for x in f}
        assert len(bins) == 228
    assert (offsets[-1] - offsets[0]) / cfg["sample_rate"] < 0.9


def test_config_text_puts_each_dongle_at_its_centre():
    from rtlsdr_airband_tpu_torch.runtime.config import loads_config

    cfg = bt.load("configs/rtl10x228.json")
    g = loads_config(entry().config_text(cfg, [f"/nowhere/d{k}.cu8" for k in range(10)]))
    assert len(g.devices) == 10 and not g.multiple_demod_threads
    ports = set()
    for k, d in enumerate(g.devices):
        assert d.centerfreq == cfg["dongles"]["centers"][k] and d.sample_format == "u8" and len(d.channels) == 228
        assert [ch.freqs[0].frequency for ch in d.channels] == (d.centerfreq + entry().channel_offsets(cfg)).tolist()
        ports |= {ch.outputs[0].dest_port for ch in d.channels}
    assert len(ports) == 2280


def test_union_counts_overlaps_once():
    union = entry().union_ms
    assert union([]) == 0.0
    assert union([(0.0, 1.0), (2.0, 3.0)]) == pytest.approx(2.0)  # one device: the sum
    assert union([(0.0, 2.0), (1.0, 3.0), (2.5, 2.75), (4.0, 5.0)]) == pytest.approx(4.0)


RECORDS = [
    rec("app.round", 99.0, 80.0),  # before the window: left out
    rec("app.round", 101.0, 90.0),
    rec("app.service", 101.0, 8.0, parent=1),
    rec("app.round", 102.0, 110.0),
    rec("app.round", 111.0, 50.0),  # after the window: left out
]


def test_round_ms_reads_the_windows_rounds(monkeypatch):
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder(RECORDS))
    assert reader("round_ms.devices").read(context()) == pytest.approx(200.0 / 4)
    assert reader("round_ms.devices").read(context(traced=False)) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: FakeRecorder([rec("app.service", 101.0, 8.0)]))  # the parent's program
    assert reader("round_ms.devices").read(context()) is None


def test_demod_readers_read_every_devices_launches():
    launches = [[2000, 228, 0]] * 10
    ops = {"void demod_kernel<64, 1>(DemodArgs)": [0.040, 80], "fade_tail_kernel": [0.004, 80], "sm80_xmma_gemm": [0.01, 320]}
    ctx = SimpleNamespace(trace_result=harness.Trace(1.0, 0.5, ops, {}, True), blocks_in_window=8,
                          counters={"k1_launches": launches})
    assert reader("demod_ms.devices").read(ctx) == pytest.approx(5.0)
    want = 100.0 * 10 * k1_bound_s(2000, 228, 0) / 5e-3
    assert reader("k1_roofline_pct.devices").read(ctx) == pytest.approx(want)
    assert 0 < want < 100
    for bare in (SimpleNamespace(trace_result=None, blocks_in_window=8, counters={"k1_launches": launches}),
                 SimpleNamespace(trace_result=harness.Trace(1.0, 0.0, {}, {}, False), blocks_in_window=8, counters={})):
        assert reader("demod_ms.devices").read(bare) is None
        assert reader("k1_roofline_pct.devices").read(bare) is None


def small_files():
    """The cell at three dongles of 16 channels, two carriers a dongle."""
    w = bt.tiny_workload(CELL)
    cfg = copy.deepcopy(bt.load("configs/rtl10x228.json"))
    cfg["dongles"].update(count=3, centers=cfg["dongles"]["centers"][:3])
    cfg["channels"]["count"] = 16
    cfg["app"].update(blocks_per_dispatch=2, active_fetch_slots=16)
    scene = bt.tiny_scene("rtl228")
    scene["carriers"] = 2
    return w, cfg, scene


@pytest.fixture
def host_kernel():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with bt.host_kernel():
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fault", [None, *faults.KINDS])
def test_small_cell_is_correct_and_a_planted_fault_is_not(fault, host_kernel):
    files = small_files()
    ctx = harness.Context(CELL, *files, 2**31 + 131, 3.0, False, torch.device("cpu"), harness.process_start())
    with faults.planted(fault) if fault else contextlib.nullcontext():
        entry().run(ctx)
    numbers = check.compare_cases(files[1], ctx.cases, files[0]["check"]["limits"])
    assert ctx.attempted > 0 and (fault is not None or ctx.counters["opened"] > 0)
    assert control.verdict(numbers, ctx.failed) is (fault is None), numbers
