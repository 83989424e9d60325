"""Every entry end to end on the CPU at a small size (``bench_tiny``), the
comparison's control, the faults it has to catch, and the reference held to
the port's plain path.

Each cell runs through ``harness.run_cell`` with the test-only ``cpu``
device, K1's host build standing in for the card's kernel: as its
configuration states it (u8), and in the other upstream sample formats.
The App in f32 is left out: the program decodes an f32 stream's ring bytes
on the host by value, not as float32 (``ops/sampleconv.py::decode_iq`` given
a uint8 array), so that run reads not correct whatever the benchmark does."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, control, faults, harness
from benchmark.tests import bench_tiny as bt

CELLS = [w["name"] for w in bt.load_bench()["workloads"]]
ENTRIES = {}
for _cell in CELLS:
    ENTRIES.setdefault(bt.load(f"workloads/{_cell}.json")["entry"], _cell)


def in_formats(cells, formats):
    """(cell, sample format, full scale) cases: the configuration's own
    format keeps the cell's name as its id.  s16 runs at a full scale of
    20000, which the App's configuration text has to carry."""
    out = []
    for cell in cells:
        for fmt in formats:
            if fmt is None:
                out.append(pytest.param(cell, None, None, id=cell))
            elif not (fmt == "f32" and bt.load(f"workloads/{cell}.json")["entry"] == "app"):
                out.append(pytest.param(cell, fmt, 20000.0 if fmt == "s16" else None, id=f"{cell}-{fmt}"))
    return out


@pytest.fixture(autouse=True)
def _host_kernel(request):
    if request.node.get_closest_marker("cuda"):
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with bt.host_kernel():
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell,fmt,fullscale", in_formats(CELLS, (None, "s8", "s16", "f32")))
def test_cell_runs_on_the_cpu_and_is_correct(cell, fmt, fullscale):
    rc, res, err = bt.run(cell, seed=2**31 + 17, sample_format=fmt, fullscale=fullscale)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "cpu" and res["device"]["kind"] == "cpu"
    assert res["attempted"] > 0 and res["failed"] == 0
    # on the CPU there is no device trace: the host clock's metrics alone
    host = {m["name"] for m in harness.cell_metrics(bt.load_bench(), cell, "end_to_end") if m["source"] == "host_clock"}
    assert "setup_s" in res["metrics"] and set(res["metrics"]) == host
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", [c for c in CELLS if c != "mixed8192.block"])
def test_traced_run_reports_host_spans(cell):
    rc, res, err = bt.run(cell, trace=1)
    assert rc == 0, err[-2000:]
    assert res["correct"]
    # on the CPU there is no device trace: the span and host clock metrics alone
    spans = {m["name"] for m in harness.cell_metrics(bt.load_bench(), cell, "per_layer")
             if m["source"] in ("program_span", "host_clock")}
    assert set(res["metrics"]) == spans
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_same_seed_same_scene():
    from benchmark.scene import make_scene

    cfg = bt.tiny_config("mixed8192")
    traffic = bt.tiny_scene("air4")
    a, b, c = (make_scene(cfg, traffic, s, "cpu").segment for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.numel() == 2 * traffic["segment_blocks"] * (cfg["wave_rate"] // 8) * 160


@pytest.mark.parametrize("cell", list(ENTRIES.values()))
def test_control_fails_where_the_program_passes(cell):
    (r,) = control.readings(cell, [2**31 + 3], 1.0, "cpu", bt.tiny_files(cell))
    assert r["program_correct"], r["program"]
    assert not r["control_correct"], r["control"]


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("cell,fmt,fullscale", in_formats(ENTRIES.values(), (None, "s8", "s16")))
def test_a_broken_timed_path_is_not_correct(cell, fmt, fullscale, fault):
    with faults.planted(fault):
        rc, res, err = bt.run(cell, seed=2**31 + 29, sample_format=fmt, fullscale=fullscale)
    assert rc == 0, err[-2000:]
    assert res["correct"] is False, res["checks"]


def test_a_reference_told_another_format_is_not_correct():
    """The format reaches the comparison: an s8 stream's cases pass against
    a reference told s8 and fail against one told u8."""
    cell = "mixed8192.block"
    workload, config, traffic = bt.tiny_files(cell, "s8")
    ctx = harness.Context(cell, workload, config, traffic, 2**31 + 37, 1.0, False, torch.device("cpu"), harness.process_start())
    harness.load_module(harness.HERE / "entries" / "block.py", "benchmark_entry_block").run(ctx)
    limits = workload["check"]["limits"]
    right = check.compare_cases(config, ctx.cases, limits)
    wrong = check.compare_cases(dict(config, sample_format="u8"), ctx.cases, limits)
    assert control.verdict(right, ctx.failed), right
    assert not control.verdict(wrong, ctx.failed), wrong


@pytest.mark.parametrize("cell", list(ENTRIES.values()))
def test_control_reports_a_planted_fault(cell):
    (r,) = control.readings(cell, [2**31 + 31], 1.0, "cpu", bt.tiny_files(cell), fault="answer_altered")
    assert r["fault"] == "answer_altered" and not r["program_correct"], r["program"]


def test_reference_agrees_with_the_ports_plain_path():
    """The reference's block (float64 channelizer, frozen plain demod) against
    the port's ``pipeline_block`` in its plain version on the same u8 bytes."""
    from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
    from rtlsdr_airband_tpu_torch.ops.window import blackman_harris_7
    from rtlsdr_airband_tpu_torch.refmodel.channel_ref import bin_for_freq
    from rtlsdr_airband_tpu_torch.runtime.pipeline import channelize_block, pipeline_block

    from benchmark.reference.channel import Reference, channel_spec, decode_u8
    from benchmark.scene import make_scene

    cfg = bt.tiny_config("mixed8192")
    C = cfg["channels"]["count"]
    scene = make_scene(cfg, bt.tiny_scene("air4"), 2**31 + 41, "cpu")
    specs = [ChannelSpec(**dataclasses.asdict(channel_spec(cfg, i))) for i in range(C)]
    fs, N, center = cfg["sample_rate"], cfg["fft_size"], cfg["center_freq"]
    params = make_channel_params(specs, wave_rate=cfg["wave_rate"], sample_rate=fs, center_freq=center, fft_size=N, device="cpu")
    bins = torch.as_tensor(np.array([bin_for_freq(s.frequency, center, fs, N) for s in specs], np.int32))
    window = torch.as_tensor(blackman_harris_7(N))
    kw = dict(hop=scene.hop, fft_size=N)
    mags, iqs = channelize_block(torch.from_numpy(decode_u8(scene.prime_bytes())), bins, window, n_frames=100, **kw)
    st = init_demod_state(C, mags, iqs)
    ref = Reference(cfg, np.arange(C))
    rst = ref.prime(scene.prime_bytes())
    for k in (0, 1):
        raw = scene.block_bytes(k)
        st, out = pipeline_block(torch.from_numpy(raw), bins, window, params, st, n_frames=scene.W, demod_backend="plain",
                                 sample_fmt="u8", fullscale=127.5, with_iq=False, **kw)
        rst, audio, flags, snap = ref.block(raw, rst)
        assert np.array_equal(out["open_flags"].numpy(), flags)
        assert np.max(np.abs(out["audio"].numpy() - audio)) < 1e-5
        for name in check.EXACT_SNAPS:
            assert np.array_equal(out[name].numpy(), snap[name]), name
        for name in check.FLOAT_SNAPS:
            np.testing.assert_allclose(out[name].numpy(), snap[name], rtol=1e-5)
    assert flags.any(), "the scene opens no channel"


@pytest.mark.cuda
def test_control_readings_on_the_card():
    """The control's readings at a small size on the card (run there with
    ``python -m pytest -m cuda benchmark/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (r,) = control.readings("mixed8192.block", [2**31 + 7], 1.0, "cuda", bt.tiny_files("mixed8192.block"))
    assert r["program_correct"], r["program"]
    assert not r["control_correct"], r["control"]
