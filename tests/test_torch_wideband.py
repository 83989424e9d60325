"""A wideband device through the port's App on the CPU: its ring holds the
block (5 MB at 20 Msps in s8, more than the 3.2 MB default) for every input
type the tests can build without hardware, a ring that cannot hold a block
fails at set-up, the whole VHF airband's shape at a small channel count
matches the benchmark's plain reference, and an f32 stream through the
App's file device equals the block program's result on the same samples.

The demod runs as K1's host build, as in the other App tests.
"""

import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import app as app_module
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline
from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise
from torch_port_common import CENTER, FS, drive_app

DEFAULT_RING = 10 * 320_000
WIDE_RATE = 20_000_000
WIDE_BLOCK = 2000 * 1250 * 2  # W samples a block, hop 1250 at 16 kHz, 2 bytes a sample


@pytest.fixture(autouse=True)
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)


def device_config(typ: str, keys: str = "", sample_rate: int = WIDE_RATE, fft_size: int = 8192) -> str:
    """One device of ``typ`` (s8 where it is a file) with two AM channels."""
    where = {"file": 'filepath = "iq.cs8"; sample_format = "s8"; speedup_factor = 0.0;',
             "soapysdr": 'device_string = "driver=hackrf";'}.get(typ, "")
    center = 127_495_833 if sample_rate == WIDE_RATE else CENTER
    chans = ", ".join(f'{{ freq = {center + off}; outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; '
                      f'dest_port = 9; }} ); }}' for off in (-400_000, 400_000))
    return (f"fft_size = {fft_size};\ndevices: ({{ type = \"{typ}\"; {where} {keys} sample_rate = {sample_rate}; "
            f"centerfreq = {center}; channels: ( {chans} ); }});\n")


@pytest.mark.parametrize(
    "typ,keys,sample_rate,ring",
    [
        pytest.param("file", "", WIDE_RATE, 4 * WIDE_BLOCK, id="file"),
        pytest.param("soapysdr", "", WIDE_RATE, 4 * WIDE_BLOCK, id="soapysdr"),
        pytest.param("rtlsdr", "", WIDE_RATE, 4 * WIDE_BLOCK, id="rtlsdr"),
        pytest.param("mirisdr", "", WIDE_RATE, 4 * WIDE_BLOCK, id="mirisdr"),
        pytest.param("rtlsdr", "buffers = 100;", WIDE_RATE, 100 * 320_000, id="rtlsdr-buffers-ask-more"),
        pytest.param("mirisdr", "num_buffers = 100;", WIDE_RATE, 100 * 320_000, id="mirisdr-num_buffers-ask-more"),
        pytest.param("file", "", FS, DEFAULT_RING, id="file-u8-2.56Msps-keeps-the-default"),
    ],
)
def test_ring_holds_four_blocks_or_what_the_keys_ask(typ, keys, sample_rate, ring):
    app = App(loads_config(device_config(typ, keys, sample_rate, 8192 if sample_rate == WIDE_RATE else 512)), device="cpu")
    rt = app.devices[0]
    assert rt.bytes_per_block == (WIDE_BLOCK if sample_rate == WIDE_RATE else 640_000)
    assert rt.input.ring.size == ring >= 4 * rt.bytes_per_block or rt.input.ring.size == ring == DEFAULT_RING
    assert rt.input.ring.size >= rt.bytes_per_block


@pytest.mark.parametrize("typ", ["file", "soapysdr", "rtlsdr", "mirisdr"])
def test_ring_smaller_than_a_block_fails_at_set_up(typ, monkeypatch):
    """A ring left at its 3.2 MB default, as every input's was before the
    rings were sized to the block: the App refuses it while it is built,
    naming both sizes, where it would otherwise wait for a whole block in
    the ring for ever."""
    monkeypatch.setattr(app_module, "RING_BLOCKS", 0)
    with pytest.raises(ValueError, match=f"{DEFAULT_RING} B.*{WIDE_BLOCK} B"):
        App(loads_config(device_config(typ)), device="cpu")


def test_wideband_app_matches_the_plain_reference():
    """The benchmark's ``vhf2280.app`` cell at 8 channels and one carrier:
    s8 at 20 Msps, ``fft_size`` 8192, one channel to a bin, read from a
    FIFO by the App's file device.  Blocks of 5 MB are handled, and what
    every channel's sink received and the block program's outputs and state
    match the plain reference (``benchmark/reference/``) within the cell's
    limits."""
    from benchmark import check, harness
    from benchmark.tests import bench_tiny

    workload, config, scene = bench_tiny.tiny_files("vhf2280.app")
    config["channels"]["count"] = 8
    workload["check"]["channels"] = 8  # all of them: the 90th percentiles over 24 readings
    scene["carriers"] = 1
    assert config["sample_format"] == "s8" and config["fft_size"] == 8192
    # three seconds: the window has to hold two chunks on a loaded CPU
    ctx = harness.Context("vhf2280.app", workload, config, scene, 2**31 + 71, 3.0, False, torch.device("cpu"),
                          harness.process_start())
    entry = harness.load_module(harness.HERE / "entries" / f"{workload['entry']}.py", "benchmark_entry_app_wide")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        entry.run(ctx)
    finally:
        torch.set_num_threads(threads)
    assert ctx.attempted > 0 and ctx.failed == 0
    assert ctx.counters["opened"] > 0
    numbers = check.compare_cases(config, ctx.cases, workload["check"]["limits"])
    assert all(v["value"] <= v["limit"] for v in numbers.values()), numbers


def test_f32_stream_through_the_app_equals_the_block_program(tmp_path):
    """CF32 through the App's file device: the ring's bytes are read as
    little-endian float32, so each block's audio and open flags equal, bit
    for bit, the same Pipeline's fed the float32 pairs themselves."""
    n = int(FS * 1.6)
    z = am_carrier_iq(FS, 400_000, n, carrier_ampl=0.35) + complex_noise(n, 0.02, 0)
    z[int(n * 0.45) : int(n * 0.62)] *= 0.0
    pairs = np.ascontiguousarray(np.stack([z.real, z.imag], axis=-1), "<f4")
    iq = tmp_path / "iq.cf32"
    iq.write_bytes(pairs.tobytes())
    text = device_config("file", sample_rate=FS, fft_size=512).replace('"iq.cs8"', f'"{iq}"').replace('"s8"', '"f32"')
    app = App(loads_config(text), device="cpu")
    rt = app.devices[0]
    got = []
    handle = app._handle_block

    def keep(rt, out):
        got.append((np.array(out["audio"]), np.array(out["active"])))
        handle(rt, out)

    app._handle_block = keep
    drive_app(app)
    p = Pipeline(rt.pipeline.cfg, rt.pipeline.specs)
    want = [(np.array(o["audio"]), np.array(o["active"])) for g in (p.feed(pairs), p.flush()) for o in g]
    assert len(got) == len(want) >= 10
    assert any(a.any() for _, a in want), "the scene opens no channel"
    for (ga, gf), (wa, wf) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(ga, wa)
