"""The port's App on the CPU: its threads (per-device sink workers, per-device
demod workers), the all-devices-up gate, and how it picks where pipelines
run (tests/test_app.py's scenes, plus the port's device choice)."""

import threading
import time

import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu_torch.app as app_mod
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch.inputs.base import InputState
from rtlsdr_airband_tpu_torch.inputs.filesrc import FileInput
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.config import ConfigError, loads_config
from torch_app_common import DeviceReplay, parity_apps
from torch_port_common import ATOL, write_am_u8

App = app_mod.App


@pytest.fixture
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)


def _udp_device(path, port) -> str:
    return f'''{{ type = "file"; filepath = "{path}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: ({{ freq = 120.4;
    outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} ); }}); }}'''


def test_multiple_output_threads_isolate_slow_sink(tmp_path, host_demod):
    """With multiple_output_threads a blocked sink on one device stalls no
    device's block cadence; its dropped blocks count as output overruns
    (reference: rtl_airband.cpp:817-819, 1056-1090, :649-655)."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=2.0)
    dev = _udp_device(iq, 57315)
    app = App(loads_config(f"fft_size = 512;\nmultiple_output_threads = true;\ndevices: ({dev}, {dev});\n"), device="cpu")
    assert all(rt.sink_worker is not None for rt in app.devices)
    blocked, release = threading.Event(), threading.Event()

    def slow_process(audio, **kw):
        blocked.set()
        release.wait(timeout=60)

    app.devices[0].channels[0].outputs.process = slow_process
    app.start()
    t0 = time.time()
    try:
        while time.time() - t0 < 90:
            app._service_once()
            if min(rt.pipeline.blocks_processed for rt in app.devices) >= 8:
                break
            if not any(rt.alive for rt in app.devices):
                break
    finally:
        release.set()
        app.stop()
    assert app.devices[0].pipeline.blocks_processed >= 8
    assert app.devices[1].pipeline.blocks_processed >= 8
    assert blocked.is_set()
    assert app.devices[0].stats.output_overrun_count > 0
    assert app.devices[1].stats.output_overrun_count == 0


def _record_blocks(app, blocks: dict, threads: set | None = None):
    lock = threading.Lock()
    handle = app._handle_block

    def record(rt, out):
        with lock:
            if threads is not None:
                threads.add(threading.current_thread().name)
            blocks.setdefault(rt.stats.index, []).append(np.asarray(out["audio"]).copy())
        handle(rt, out)

    app._handle_block = record


def test_multiple_demod_threads_per_device_workers(tmp_path, monkeypatch):
    """multiple_demod_threads runs one demod worker per device (reference:
    rtl_airband.cpp:809-816, 1052-1090), each pipeline fed on its worker's
    thread and flushed on the main thread: both devices' audio equals the
    single-threaded loop's bit for bit, which equals a one-device run of
    each file bit for bit, which the JAX App's one-device run matches within
    1e-4.  The JAX App runs one device a run (its recording follows one
    dispatch order); the port's two-device runs replay both recordings,
    each call matched to its device (tests/torch_app_common.py::DeviceReplay)."""
    paths = [tmp_path / "iq0.bin", tmp_path / "iq1.bin"]
    write_am_u8(paths[0], secs=1.5, tone=700.0)
    write_am_u8(paths[1], secs=1.5, tone=1300.0)
    solo, recordings = [], []
    for path in paths:
        recorded, calls = [], []

        def setup(app, recorded=recorded):
            recorded.append({})
            _record_blocks(app, recorded[-1])

        parity_apps(monkeypatch, f"fft_size = 512;\ndevices: ({_udp_device(path, 57411)});\n", setup=setup, calls=calls)
        jax_blocks, port_blocks = (r[0] for r in recorded)
        assert len(port_blocks) == len(jax_blocks) >= 8
        for k, (a, b) in enumerate(zip(jax_blocks, port_blocks)):
            assert np.abs(a.astype(np.float64) - b).max() <= ATOL, f"{path.name} block {k}"
        solo.append(port_blocks)
        recordings.append(calls)

    def collect(mdt):
        replay = DeviceReplay(monkeypatch, recordings)
        devs = ", ".join(_udp_device(p, port) for p, port in zip(paths, (57411, 57412)))
        app = App(loads_config(f"fft_size = 512;\nmultiple_demod_threads = {mdt};\ndevices: ({devs});\n"), device="cpu")
        blocks, threads = {}, set()
        _record_blocks(app, blocks, threads)
        app.run(max_seconds=90.0)
        assert replay.all_replayed()
        return blocks, threads

    single, threads_st = collect("false")
    assert all(not t.startswith("demod-") for t in threads_st)
    multi, threads_mt = collect("true")
    assert {t for t in threads_mt if t.startswith("demod-")} == {"demod-0", "demod-1"}
    for di in (0, 1):
        assert len(multi[di]) == len(single[di]) == len(solo[di]), (di, len(multi[di]), len(single[di]), len(solo[di]))
        for k, (a, b, c) in enumerate(zip(solo[di], single[di], multi[di])):
            np.testing.assert_array_equal(a, b, err_msg=f"device {di} block {k}: one-device run vs single thread")
            np.testing.assert_array_equal(b, c, err_msg=f"device {di} block {k}: single thread vs worker thread")


def _stuck_or_failing(monkeypatch, iq, cls, want_type):
    def fake_input_new(typ, **kw):
        assert typ == want_type
        return cls(filepath=str(iq), sample_rate=kw["sample_rate"], centerfreq=kw["centerfreq"])

    monkeypatch.setattr(app_mod, "input_new", fake_input_new)


def test_startup_gate_aborts_on_dead_device(tmp_path, monkeypatch):
    """reference: rtl_airband.cpp:1024-1032 — wait up to 5 s for every
    input to come up, fatal when one never does."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=0.5)

    class StuckInput(FileInput):
        def start(self):  # the rx thread never launches: state stays INITIALIZED
            pass

    _stuck_or_failing(monkeypatch, iq, StuckInput, "file")
    cfg = loads_config(f"devices: ( {_udp_device(iq, 4100)} );")
    app = App(cfg, device="cpu")
    assert app.devices[0].input.state == InputState.UNKNOWN
    with pytest.raises(RuntimeError, match="failed to initialize"):
        app.start(gate_timeout=0.3)


def test_startup_gate_hw_failure_is_fatal_immediately(tmp_path, monkeypatch):
    """A hardware device whose rx thread FAILS inside the gate window aborts
    at once (reference: count_devices_running counts only INPUT_RUNNING,
    rtl_airband.cpp:1024-1032); file inputs keep the EOF->FAILED exemption."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=0.5)

    class FailingInput(FileInput):
        def start(self):
            self.state = InputState.FAILED

    _stuck_or_failing(monkeypatch, iq, FailingInput, "rtlsdr")
    cfg = loads_config(
        'devices: ( { type = "rtlsdr"; index = 0; gain = 25.4; sample_rate = 2560000; centerfreq = 120.0; '
        'channels: ( { freq = 120.4; outputs: ( { type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 4101; } ); } ); } );'
    )
    app = App(cfg, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed to initialize"):
        app.start(gate_timeout=30.0)
    assert time.monotonic() - t0 < 5.0


def _one_device(tmp_path, extra=""):
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=0.2)
    return loads_config(f"{extra}devices: ( {_udp_device(iq, 4103)} );")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_app_defaults_to_the_card_and_raises_without_one(tmp_path):
    """App(cfg) runs its pipelines on the card; without one it raises and
    never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        App(_one_device(tmp_path))


def test_mesh_devices_raise(tmp_path):
    """mesh_devices = N > 1 on the card takes the first N distinct GPUs and
    raises when fewer are present (here none: the default device is the
    card); it never repeats a GPU.  On the CPU it takes N CPU cells, and
    mesh_devices = 1 runs no mesh."""
    have = torch.cuda.device_count()
    want = max(2, have + 1)
    with pytest.raises(ValueError, match=f"mesh_devices = {want} but only {have} GPU"):
        App(_one_device(tmp_path, f"mesh_devices = {want};\n"))
    app = App(_one_device(tmp_path, "mesh_devices = 2;\n"), device="cpu")
    assert app.mesh.shape == {"time": 1, "chan": 2} and app.mesh.cells == [torch.device("cpu")] * 2
    assert app.devices[0].pipeline.mesh is not None
    one = App(_one_device(tmp_path, "mesh_devices = 1;\n"), device="cpu")
    assert one.mesh is None and len(one.devices) == 1 and one.devices[0].pipeline.mesh is None


@pytest.mark.parametrize("value, backend", [("auto", "cuda"), ("pallas", "cuda"), ("cuda", "cuda"), ("xla", "plain"), ("plain", "plain")])
def test_app_maps_demod_backend(tmp_path, value, backend):
    """A config's demod_backend reaches every PipelineConfig mapped: the
    JAX package's values as the port's, the port's own unchanged."""
    app = App(_one_device(tmp_path, f'demod_backend = "{value}";\n'), device="cpu")
    assert app.demod_backend == backend
    assert [rt.pipeline.cfg.demod_backend for rt in app.devices] == [backend]
    assert [rt.pipeline.cfg.device for rt in app.devices] == ["cpu"]


def test_unknown_demod_backend_is_a_config_error(tmp_path):
    with pytest.raises(ConfigError, match="demod_backend"):
        _one_device(tmp_path, 'demod_backend = "tpu";\n')
