"""Every upstream sample format (u8, s8, s16, f32) through the benchmark's
decode, scene and block entry, and u8 held to what the benchmark read before
it took the other formats: the same scene bytes, the same reference outputs
and the same launches of the timed path."""

from __future__ import annotations

import hashlib
import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.channel import BYTES_PER_SAMPLE, Reference, decode, decode_u8
from benchmark.scene import make_scene
from benchmark.tests import bench_tiny as bt

FORMATS = ("u8", "s8", "s16", "f32")

# (raw values, their little-endian dtype, full scale or None, the levels they decode to)
EXTREMES = {
    "u8": ([0, 255], "u1", None, [-1.0, 1.0]),
    "s8": ([-128, 127], "i1", None, [-1.0, 127 / 128]),
    "s16": ([-32768, 32767], "<i2", None, [-1.0, 32767 / 32768]),
    "f32": ([-1.0, 1.0], "<f4", None, [-1.0, 1.0]),
    "s16@16384": ([-32768, 32767], "<i2", 16384.0, [-2.0, 32767 / 16384]),
    "f32@2.5": ([-1.0, 1.0], "<f4", 2.5, [-0.4, 0.4]),
}


@pytest.mark.parametrize("case", list(EXTREMES))
def test_decode_reads_each_formats_extremes(case):
    values, dtype, fullscale, want = EXTREMES[case]
    raw = np.frombuffer(np.array(values, dtype).tobytes(), np.uint8)
    got = decode(raw, case.split("@")[0], fullscale)
    assert got.dtype == np.float32 and got.shape == (1, 2)
    assert np.array_equal(got.ravel(), np.array(want, np.float32))


def test_u8_decode_keeps_its_arithmetic():
    raw = np.arange(256, dtype=np.uint8)
    frozen = ((raw.astype(np.float64) - 127.5) / 127.5).astype(np.float32).reshape(-1, 2)
    assert np.array_equal(decode(raw, "u8"), frozen)
    assert np.array_equal(decode_u8(raw), frozen)


def _raw_stream(fmt: str, n: int = 4096) -> np.ndarray:
    """Every byte value (u8, s8), the whole int16 range's ends and random
    values (s16), random levels in [-1.25, 1.25] (f32): raw bytes."""
    rng = np.random.default_rng(17)
    if fmt in ("u8", "s8"):
        return np.concatenate([np.arange(256, dtype=np.uint8), rng.integers(0, 256, n, dtype=np.uint8)])
    if fmt == "s16":
        v = np.concatenate([[-32768, 32767, 0, -1], rng.integers(-32768, 32768, n)]).astype("<i2")
    else:
        v = rng.uniform(-1.25, 1.25, n).astype("<f4")
    return np.frombuffer(v.tobytes(), np.uint8)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_matches_the_ports_decoders_bit_for_bit(fmt):
    """At default full scales: the port's host decoder and its device decoder
    (here on the CPU) read the same raw bytes to the same float32 levels."""
    from rtlsdr_airband_tpu_torch.ops.channelizer import decode_raw_iq
    from rtlsdr_airband_tpu_torch.ops.sampleconv import SampleFormat, decode_iq, default_fullscale

    raw = _raw_stream(fmt)
    ref = decode(raw, fmt)
    host = decode_iq(raw.tobytes(), SampleFormat(fmt), None)
    typed = torch.from_numpy(raw.copy()).view({"s16": torch.int16, "f32": torch.float32}.get(fmt, torch.uint8))
    dev = decode_raw_iq(typed, fmt, default_fullscale(SampleFormat(fmt))).numpy()
    assert ref.shape == (len(raw) // BYTES_PER_SAMPLE[fmt], 2)
    assert np.array_equal(ref, host) and np.array_equal(ref, dev)


@pytest.mark.parametrize("fmt", FORMATS)
def test_scene_length_and_range(fmt):
    """Each format's segment holds the same air: its length in bytes, its
    values in the format's range, and its levels those of the f32 segment
    to within half a quantisation step where the air stays inside full
    scale."""
    traffic = bt.tiny_scene("air4")
    seed = 2**31 + 11
    cfg = bt.tiny_config("am8192", fmt)
    seg = make_scene(cfg, traffic, seed, "cpu").segment
    n = traffic["segment_blocks"] * (cfg["wave_rate"] // 8) * 160
    assert seg.dtype == torch.uint8 and seg.dim() == 1 and seg.numel() == BYTES_PER_SAMPLE[fmt] * n
    z = decode(make_scene(bt.tiny_config("am8192", "f32"), traffic, seed, "cpu").segment.numpy(), "f32")
    got = decode(seg.numpy(), fmt)
    if fmt == "f32":
        assert np.isfinite(got).all() and np.abs(got).max() < 1.5  # four carriers' peaks and the noise, unclipped
        return
    lo, hi, step = {"u8": (-1.0, 1.0, 1 / 127.5), "s8": (-1.0, 127 / 128, 1 / 128), "s16": (-1.0, 32767 / 32768, 1 / 32768)}[fmt]
    assert got.min() >= lo and got.max() <= hi
    assert np.any(got == lo) or np.any(got == hi), "the carriers' peaks reach full scale"
    inside = (z > lo) & (z < hi)
    assert np.max(np.abs(got - z)[inside]) <= step / 2 + 1e-6  # half a step, and float32's rounding of the levels


# sha256 of the u8 segment at full size (air4) and seed, as the benchmark made it
# before it took other formats
U8_SCENES = {
    ("mixed8192", 2**31 + 5): "8906f74cc07be8467f7c93f16bd099042bd7a7b63f1d244dbd47d1369323a16b",
    ("mixed8192", 12345678901): "08270d77016c53177a71cf90a8ef19045c822fa0b7a0fc07c0ee0b09cf1d8360",
    ("am8192", 2**31 + 5): "c613299320038631ff43be4a66335a85fc70adde20f2c3566a79e39e54d03958",
    ("am8192", 12345678901): "897e70f7952c7c89d955efeea19c9cc18e1e29c7f52c81c24294873f65cfd186",
}


@pytest.mark.parametrize("config,seed", list(U8_SCENES))
def test_u8_scene_is_the_one_made_before(config, seed):
    cfg = bt.load(f"configs/{config}.json")
    seg = make_scene(cfg, bt.load("scenes/air4.json"), seed, "cpu").segment
    assert seg.numel() == 2 * 16 * 2000 * 160
    assert hashlib.sha256(seg.numpy().tobytes()).hexdigest() == U8_SCENES[(config, seed)]


# sha256 of the reference's block 2 (audio, open flags, snapshots) from the
# stream's start, channels 0, 3, ..., 30 at the small size, seed 2**31 + 43,
# as the benchmark computed it before it took other formats
U8_REFERENCE = {
    "mixed8192": "6071b5a0a29841e7f0258d529babc1b602463ea6d83c17772290435ce761d49d",
    "am8192": "32c55cea656459974d88b3f9afa99ea14e0376d0a870c0f8aa29524925831fd3",
}


@pytest.mark.parametrize("config", list(U8_REFERENCE))
def test_u8_reference_outputs_are_the_ones_computed_before(config):
    cfg = bt.tiny_config(config)
    scene = make_scene(cfg, bt.tiny_scene("air4"), 2**31 + 43, "cpu")
    ref = Reference(cfg, np.arange(0, 32, 3))
    _, audio, flags, snap = ref.block(scene.block_bytes(2), ref.prime(scene.prime_bytes()))
    h = hashlib.sha256(audio.tobytes())
    h.update(flags.tobytes())
    for name in sorted(snap):
        h.update(snap[name].tobytes())
    assert h.hexdigest() == U8_REFERENCE[config]


def _block_program(fmt: str, fullscale=None):
    cell = "mixed8192.block"
    workload, config, traffic = bt.tiny_files(cell, fmt, fullscale)
    ctx = harness.Context(cell, workload, config, traffic, 2**31 + 3, 1.0, False, torch.device("cpu"), harness.process_start())
    entry = harness.load_module(harness.HERE / "entries" / "block.py", "benchmark_entry_block")
    scene = ctx.scene()
    return scene, entry.build(ctx, scene)


@pytest.mark.parametrize("fmt,fullscale", [("u8", None), ("s8", None), ("s16", None), ("f32", None), ("s16", 20000.0), ("f32", 2.5)])
def test_block_entry_feeds_the_scenes_bytes_in_its_format(fmt, fullscale):
    """The timed loop's inputs are the scene's blocks, typed as the device
    decode takes them, and the program decodes the configuration's format;
    for u8 the launches are the ones made before other formats: the same
    keyword arguments and the same u8 slices."""
    scene, (block, xs, _, _) = _block_program(fmt, fullscale)
    want_dtype = {"s16": torch.int16, "f32": torch.float32}.get(fmt, torch.uint8)
    default = {"s16": 32768.0, "f32": 1.0}.get(fmt, 127.5)  # u8 and s8 decode by a fixed rule
    assert block.block_kwargs["sample_fmt"] == fmt and block.block_kwargs["fullscale"] == (fullscale or default)
    assert len(xs) == bt.tiny_scene("air4")["segment_blocks"]
    for j, x in enumerate(xs):
        assert x.dtype == want_dtype and x.is_contiguous() and x.numel() == 2 * scene.block_len
        assert np.array_equal(x.numpy().view(np.uint8), scene.block_bytes(j))
    if fmt == "u8":
        assert block.block_kwargs == dict(hop=160, fft_size=512, n_frames=2000, fm_quadri=False, with_ctcss=True, with_iq=False,
                                          sample_fmt="u8", fullscale=127.5)


def test_app_config_text_states_the_format_and_full_scale():
    from rtlsdr_airband_tpu_torch.runtime.config import load_config

    app = harness.load_module(harness.HERE / "entries" / "app.py", "benchmark_entry_app")
    for fmt, fullscale in (("u8", None), ("s16", 20000.0)):
        text = app.config_text(bt.tiny_config("am8192", fmt, fullscale), "scene.raw")
        assert (f"fullscale = {fullscale!r};" in text) == (fullscale is not None)
        with tempfile.NamedTemporaryFile("w", suffix=".conf") as f:
            f.write(text)
            f.flush()
            (dev,) = load_config(f.name).devices
        assert dev.sample_format == fmt and dev.fullscale == fullscale
