"""Port parity of the streaming path: the port's ``Pipeline`` and
``pipeline_chain`` against the JAX package's on the same byte streams
(through one recorded channelizer output, see tests/torch_jax_replay.py),
the host decode of every sample format, and the two places where PyTorch
could order or round otherwise than JAX: the slot gather's ties (H1) and the
block-float pack at .5 boundaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu.runtime.pipeline as jax_pipeline
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu import native
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.sampleconv import make_u8_lut
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.runtime.pipeline import quantize_audio, select_slots
from torch_jax_replay import RecordedChannelizer, assert_blocks_close, jax_state
from torch_port_common import ATOL, CENTER, FS, NFM_SCENE_SPECS, SCENE_SPECS, feed_all, nfm_scene_u8, scene_u8


def _pipelines(specs=SCENE_SPECS, **cfg):
    """(JAX Pipeline, port Pipeline) of one configuration, u8 input at
    wave_rate 8000 unless ``cfg`` says otherwise."""
    kw = dict(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="u8", fullscale=127.5)
    kw.update(cfg)
    jp = jax_pipeline.Pipeline(jax_pipeline.PipelineConfig(**kw), [JaxSpec(**s) for s in specs])
    tp = port_pipeline.Pipeline(port_pipeline.PipelineConfig(device="cpu", **kw), [ChannelSpec(**s) for s in specs])
    return jp, tp


FORMATS = {
    "u8": lambda rng: rng.integers(0, 256, 4096).astype(np.uint8).tobytes(),
    "s8": lambda rng: rng.integers(-128, 128, 4096).astype(np.int8).tobytes(),
    "s16": lambda rng: rng.integers(-32768, 32768, 4096).astype(np.int16).tobytes(),
    "f32": lambda rng: rng.normal(0, 1000.0, 4096).astype(np.float32).tobytes(),
    "f32c": lambda rng: (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(np.complex64),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decode_matches_jax_decode(monkeypatch, fmt):
    """``Pipeline._decode`` against the JAX one, bit for bit, with the JAX
    package's numpy decoder (its native converter is the App slice's)."""
    monkeypatch.setattr(native, "native_available", lambda: False)
    raw = FORMATS[fmt](np.random.default_rng(9))
    jp, tp = _pipelines(sample_format=fmt, fullscale={"s16": 32768.0, "f32": 1000.0}.get(fmt, 127.5))
    want, got = jp._decode(raw), tp._decode(raw)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_u8_decode_follows_the_lut():
    """The port decodes u8 as the reference's LUT does, (x - 127.5) / 127.5,
    as the JAX package's LUT and device decode do.  The JAX package's native
    converter (native/ingest.cpp::convert_u8_f32) multiplies by 1/127.5
    instead and lands one ulp away on about half the codes: the JAX
    Pipeline, when that library is built, primes from slightly other
    values than its device decode gives for the same bytes."""
    codes = np.arange(256, dtype=np.uint8).repeat(2).tobytes()
    _, tp = _pipelines()
    got = tp._decode(codes).reshape(-1)[::2]
    assert got.tobytes() == make_u8_lut().tobytes()
    if native.native_available():
        nat = native.convert_iq(codes, "u8").reshape(-1)[::2]
        off = np.abs(nat.view(np.int32) - got.view(np.int32))
        assert off.max() == 1 and 0 < (off > 0).sum() < 256


CONFIGS = {
    # the dense fetch with per-sample flags, async depth 1
    "dense": dict(scene="am", chunk_blocks=4, async_depth=1, fetch_open_flags=True),
    # the production fetch economy: slots, block-float, fade-tail
    # suppression, one meta snapshot a chunk, on the NFM scene
    "economy": dict(scene="nfm", specs=NFM_SCENE_SPECS, chunk_blocks=4, async_depth=1, active_slots=2,
                    fetch_audio_fmt="i8bf", suppress_fade_tails=True, fetch_meta_per_chunk=True),
    # one slot for three channels: overflow counted, fade synthesized on the
    # dropped channels (H4), int16 audio
    "overflow": dict(scene="am", chunk_blocks=2, async_depth=0, active_slots=1, fetch_audio_fmt="i16",
                     suppress_fade_tails=True),
    # the FFT channelizer and the AFC spectrum
    "fft_afc": dict(scene="am1.0", chunk_blocks=2, async_depth=1, channelizer="fft", afc=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_matches_jax(monkeypatch, name):
    cfg = dict(CONFIGS[name])
    raw = {"am": scene_u8, "am1.0": lambda: scene_u8(1.0), "nfm": nfm_scene_u8}[cfg.pop("scene")]()
    specs = [dict(s) for s in cfg.pop("specs", SCENE_SPECS)]
    if cfg.pop("afc", False):
        specs[0]["afc"] = 2
    rec = RecordedChannelizer(monkeypatch)
    jp, tp = _pipelines(specs, **cfg)
    want = rec.jax_run(lambda: feed_all(jp, raw))
    got = feed_all(tp, raw)
    assert rec.all_replayed()
    assert_blocks_close(want, got, name, audio_step=cfg.get("fetch_audio_fmt"))
    assert any(o["active"].any() for o in want)
    assert jp.gather_overflow_count == tp.gather_overflow_count
    if name == "overflow":
        assert tp.gather_overflow_count > 0
    if name == "fft_afc":
        assert all(o["spectrum_power"].shape == (512,) for o in got)
    np.testing.assert_allclose(tp._tail_pending, np.asarray(jp._tail_pending), rtol=0, atol=ATOL)
    for k, v in interop.state_to_numpy(tp.state).items():
        a = np.asarray(getattr(getattr(jp.state, k.split(".")[0]), k.split(".")[1]) if "." in k else getattr(jp.state, k))
        assert a.dtype == v.dtype and a.shape == v.shape, k
        if v.dtype.kind in "biu":
            assert np.array_equal(a, v), k


@pytest.mark.parametrize("audio_fmt", ["i16", "i8bf"])
def test_chain_packing_matches_jax(monkeypatch, audio_fmt):
    """One pipeline_chain call of 4 blocks from a mid-stream state, one slot
    for three channels: ``slot_channel``, ``n_active``, ``active`` and the
    int meta equal JAX's exactly, the audio mantissas within one step, the
    block-float scales and float meta within 1e-4."""
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    jp, tp = _pipelines(chunk_blocks=1, active_slots=1, fetch_audio_fmt=audio_fmt)
    raw = scene_u8()
    # the port, with its own channelizer, takes the stream to block 6, just
    # as the carrier is gated off; both chains start from that state and
    # run through the fade tails and the two channels that open after it
    for i in range(0, len(raw), 64_000):
        list(tp.feed(raw[i : i + 64_000]))
        if tp.blocks_processed == 6:
            break
    k = 4
    n_in = (k * tp.W - 1) * tp.hop + tp.N
    off = tp.A * tp.hop + tp.blocks_processed * tp.W * tp.hop
    x = np.frombuffer(raw, np.uint8)[2 * off : 2 * (off + n_in)]
    flat = interop.state_to_numpy(tp.state)
    rec = RecordedChannelizer(monkeypatch)
    _, want = rec.jax_run(lambda: jax_pipeline.pipeline_chain(
        jnp.asarray(x), jp.bins, jp.window, jp.params, jax_state(flat),
        k_blocks=k, taps=jp._taps, inv_perm=jp._inv_perm, **jp._chain_kwargs("u8")))
    _, got = port_pipeline.pipeline_chain(
        torch.from_numpy(x.copy()), tp.bins, tp.window, tp.params, interop.state_from_numpy(flat, device="cpu"),
        k_blocks=k, taps=tp._taps, inv_perm=tp._inv_perm, **tp._chain_kwargs("u8"))
    assert rec.all_replayed()
    want = {key: np.asarray(v) for key, v in want.items()}
    got = {key: v.numpy() for key, v in got.items()}
    keys = {"audio", "active", "meta_f", "meta_i", "slot_channel", "n_active"} | ({"audio_scale"} if audio_fmt == "i8bf" else set())
    assert want.keys() == got.keys() == keys
    for key in want:
        assert want[key].dtype == got[key].dtype and want[key].shape == got[key].shape, key
    for key in ("slot_channel", "n_active", "active", "meta_i"):
        np.testing.assert_array_equal(want[key], got[key], err_msg=key)
    assert np.abs(want["audio"].astype(np.int32) - got["audio"]).max() <= 1
    for key in ("meta_f",) + (("audio_scale",) if audio_fmt == "i8bf" else ()):
        assert np.abs(want[key].astype(np.float64) - got[key]).max() <= ATOL, key
    # the chunk holds blocks where more channels want the slot than it holds
    assert (want["n_active"] > 1).any()


@pytest.mark.parametrize("case", ["sparse", "dense", "all_equal"])
def test_slot_ties_match_jax_top_k(case):
    """H1: the slot gather keeps the S best scores with ties to the lower
    channel index, exactly as ``jax.lax.top_k`` orders them, for score
    vectors with many ties at C > S."""
    rng = np.random.default_rng({"sparse": 0, "dense": 1, "all_equal": 2}[case])
    C, S = 1000, 64
    if case == "all_equal":
        score = np.full(C, 2, np.int32)
    else:
        p = [0.85, 0.1, 0.04, 0.01] if case == "sparse" else [0.1, 0.3, 0.3, 0.3]
        score = rng.choice(4, C, p=p).astype(np.int32)
    jv, ji = jax.lax.top_k(jnp.asarray(score), S)
    tv, ti = select_slots(torch.from_numpy(score), S)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_i8bf_pack_at_half_steps_matches_jax():
    """The block-float pack of values at or next to .5 mantissa boundaries,
    and of silent columns, equals the JAX pack bit for bit (the expression
    of rtlsdr_airband_tpu/runtime/pipeline.py:402-405, jitted).  A pack that
    divides 127 by the scale through a reciprocal differs on these inputs,
    so the test sees that trap."""
    rng = np.random.default_rng(5)
    W, S = 64, 4096
    scale = rng.uniform(0.01, 1.0, S).astype(np.float32)
    inv = np.float32(127.0) / scale
    m = rng.integers(-126, 126, (W, S))
    a = np.clip(((m + 0.5) / inv.astype(np.float64)).astype(np.float32), -scale, scale)
    a[0] = scale  # each column's peak is its scale
    a[:, :8] = 0.0  # silent columns stay exactly silent

    @jax.jit
    def jax_pack(a):
        scale = jnp.max(jnp.abs(a), axis=0)
        q = jnp.round(a * jnp.where(scale > 0.0, np.float32(127.0) / scale, 0.0)[None, :])
        return q.astype(jnp.int8), scale * np.float32(1.0 / 127.0)

    jq, js = (np.asarray(v) for v in jax_pack(jnp.asarray(a)))
    got = quantize_audio(torch.from_numpy(a), "i8bf")
    assert got["audio"].dtype == torch.int8 and got["audio_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["audio"].numpy(), jq)
    assert got["audio_scale"].numpy().tobytes() == js.tobytes()
    assert not jq[:, :8].any()
    ta = torch.from_numpy(a)
    naive = torch.round(ta * (127.0 / ta.abs().amax(0))[None, :]).to(torch.int8).numpy()
    assert (naive[:, 8:] != jq[:, 8:]).any()
