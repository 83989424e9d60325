"""The port's App with several SDR devices on the CPU, as the benchmark's
``rtl10x228.app`` cell runs it at a small size: three u8 file devices at
2.56 Msps, 16 AM channels each, at three centres 1.9 MHz apart, each with a
seeded scene of its own.

- Each device's sampled sinks match the plain reference
  (``benchmark/reference/``) run on that device's own stream, within
  ``am8192.app``'s limits, through the ``app_devices`` entry; a closed
  channel's sink sends nothing.
- The three devices in one App equal each device run alone, bit for bit,
  in the single loop and with ``multiple_demod_threads``.
- ``app.round`` opens once a pass of ``App._service_once``, and the
  ``app.devices_serviced`` counts add up to the blocks the devices handed
  to their pipelines.

The demod runs as K1's host build, as in the other App tests.
"""

import copy
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime import trace
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from torch_port_common import drive_app

CELL = "rtl10x228.app"
DEVICES = 3
CHANNELS = 16
SEED = 2**31 + 113


@pytest.fixture
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(threads)


def small_files(centers: list[int] | None = None):
    """The cell's (workload, configuration, scene) at three devices of 16
    channels, two carriers a device, chunks of two blocks, 16 slots."""
    from benchmark.tests import bench_tiny

    workload = bench_tiny.tiny_workload(CELL)
    cfg = copy.deepcopy(bench_tiny.load("configs/rtl10x228.json"))
    centers = cfg["dongles"]["centers"][:DEVICES] if centers is None else centers
    cfg["dongles"].update(count=len(centers), centers=centers)
    cfg["center_freq"] = centers[0]
    cfg["channels"]["count"] = CHANNELS
    cfg["app"].update(blocks_per_dispatch=2, active_fetch_slots=16)
    scene = bench_tiny.tiny_scene("rtl228")
    scene["carriers"] = 2
    return workload, cfg, scene


def entry():
    from benchmark import harness

    return harness.load_module(harness.HERE / "entries" / "app_devices.py", "benchmark_entry_app_devices")


def test_each_device_matches_the_reference_on_its_own_stream(host_demod):
    from benchmark import check, harness

    workload, cfg, scene = small_files()
    assert len(set(cfg["dongles"]["centers"])) == DEVICES
    # three seconds: the window has to hold two chunks of air on a loaded CPU
    ctx = harness.Context(CELL, workload, cfg, scene, SEED, 3.0, False, torch.device("cpu"), harness.process_start())
    entry().run(ctx)
    assert ctx.attempted > 0 and ctx.failed == 0 and ctx.counters["opened"] > 0
    assert len(ctx.counters["blocks_a_device"]) == DEVICES and min(ctx.counters["blocks_a_device"]) > ctx.attempted
    assert len(ctx.cases) == DEVICES * len(ctx.counters["checked_blocks"])
    am_limits = harness.load_json(harness.HERE / "workloads" / "am8192.app.json")["check"]["limits"]
    numbers = check.compare_cases(cfg, ctx.cases, am_limits)
    assert all(v["value"] <= v["limit"] for v in numbers.values()), numbers
    sent = np.concatenate([c["delivered"]["sent"] for c in ctx.cases])
    opened = np.concatenate([c["open_flags"].any(axis=0) for c in ctx.cases])
    np.testing.assert_array_equal(sent, opened)  # a closed channel's sink sends nothing
    assert sent.any() and not sent.all()


def write_streams(tmp_path, files) -> list[str]:
    """Each device's scene from its own seed, a little over a second of it,
    as a u8 file."""
    from benchmark.scene import make_scene

    _, cfg, scene = files
    paths = []
    for k in range(cfg["dongles"]["count"]):
        seg = make_scene(cfg, scene, entry().device_seed(SEED, k), "cpu").host
        path = tmp_path / f"dongle{k}.cu8"
        path.write_bytes(np.tile(seg, 3).tobytes())
        paths.append(str(path))
    return paths


def run_app(text: str) -> dict[int, list[np.ndarray]]:
    """Every block's audio a device, as the App handled it."""
    app = App(loads_config(text), device="cpu")
    blocks: dict[int, list[np.ndarray]] = {}
    lock = threading.Lock()
    handle = app._handle_block

    def record(rt, out):
        with lock:
            blocks.setdefault(rt.stats.index, []).append(np.array(out["audio"]))
        handle(rt, out)

    app._handle_block = record
    app.run(max_seconds=120.0)
    return blocks


def alone(files, paths, k: int) -> str:
    _, cfg, _ = files
    one = copy.deepcopy(cfg)
    one["dongles"].update(count=1, centers=[cfg["dongles"]["centers"][k]])
    one["center_freq"] = one["dongles"]["centers"][0]
    return entry().config_text(one, [paths[k]])


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """Each device's blocks from an App that holds it alone."""
    mp = pytest.MonkeyPatch()
    mp.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    try:
        files = small_files()
        paths = write_streams(tmp_path_factory.mktemp("devices"), files)
        return files, paths, [run_app(alone(files, paths, k))[0] for k in range(DEVICES)]
    finally:
        mp.undo()


@pytest.mark.parametrize("threads", [False, True])
def test_three_devices_equal_each_device_alone(solo, threads, host_demod):
    files, paths, want = solo
    cfg = copy.deepcopy(files[1])
    cfg["multiple_demod_threads"] = threads
    got = run_app(entry().config_text(cfg, paths))
    assert sorted(got) == list(range(DEVICES))
    for k in range(DEVICES):
        assert len(got[k]) == len(want[k]) >= 8, (k, len(got[k]), len(want[k]))
        assert any(a.any() for a in want[k]), f"device {k}'s scene opens no channel"
        for b, (g, w) in enumerate(zip(got[k], want[k])):
            np.testing.assert_array_equal(g, w, err_msg=f"device {k} block {b}")


def test_round_span_and_devices_serviced_counter(solo, host_demod):
    files, paths, _ = solo
    app = App(loads_config(entry().config_text(files[1], paths)), device="cpu")
    passes, reads = [0], [0] * DEVICES
    service_once = app._service_once

    def counted_pass():
        passes[0] += 1
        return service_once()

    app._service_once = counted_pass
    for k, rt in enumerate(app.devices):
        read = rt.input.read_bytes

        def counted_read(n, _read=read, _k=k, _rt=rt):
            out = _read(n)
            if n == _rt.bytes_per_block and out is not None:
                reads[_k] += 1
            return out

        rt.input.read_bytes = counted_read
    with profile(activities=[ProfilerActivity.CPU]):
        drive_app(app)
    recs = trace.records()
    rounds = [i for i, r in enumerate(recs) if r[0] == "app.round"]
    assert len(rounds) == passes[0] > 0
    services = [r for r in recs if r[0] == "app.service"]
    assert services and all(r[4] in rounds for r in services)
    assert min(reads) > 0 and trace.counters()["app.devices_serviced"] == sum(reads) == len(services)
