"""Port of tests/test_pipeline_chain.py to the port's own Pipeline on the CPU:
the chained dispatch (pipeline_chain, chunk_blocks / async_depth) equals
single-block dispatch bit for bit, the device decode equals the host
decoder for every format, and the fetch economy (active-channel gather,
int16 and block-float audio, fade-tail suppression, meta per chunk) keeps
its bounds against the dense fetch.

The demod runs as K1's host build (``demod_cuda.demod_block_host``, the
kernel's own code built with g++), which tests/test_torch_demod_tiled.py
holds equal to the plain version bit for bit; the plain version takes some
twenty times longer on these scenes."""

import functools

import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import _build
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.channelizer import decode_raw_iq
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.ops.sampleconv import SampleFormat, decode_iq
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from torch_port_common import CENTER, FS, NFM_SCENE_SPECS, SCENE_SPECS, feed_all, nfm_scene_u8, scene_u8


@pytest.fixture(autouse=True)
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)


@pytest.mark.parametrize("sfmt,fullscale", [("u8", 127.5), ("s8", 128.0), ("s16", 32768.0), ("f32", 1.0)])
def test_decode_raw_iq_matches_host(sfmt, fullscale):
    """The device decode (decode_raw_iq, inside the block program) equals
    the host decoder (reference LUT semantics, rtl_airband.cpp:316-324,
    402-438) bit for bit."""
    rng = np.random.default_rng(3)
    n = 4096
    raw = {
        "u8": lambda: rng.integers(0, 256, 2 * n).astype(np.uint8),
        "s8": lambda: rng.integers(-128, 128, 2 * n).astype(np.int8),
        "s16": lambda: rng.integers(-32768, 32768, 2 * n).astype(np.int16),
        "f32": lambda: rng.normal(0, 0.5, 2 * n).astype(np.float32),
    }[sfmt]()
    dev = decode_raw_iq(torch.from_numpy(raw.view(np.uint8) if sfmt == "s8" else raw), sfmt, fullscale)
    host = decode_iq(raw.tobytes(), SampleFormat(sfmt), fullscale)
    np.testing.assert_array_equal(dev.numpy(), host)


def _specs(kws=SCENE_SPECS):
    return [ChannelSpec(**k) for k in kws]


def _config(chunk, depth, slots=0, i16=False, fmt="", suppress=False, flags=True, meta_per_chunk=False):
    return PipelineConfig(
        sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="u8",
        fullscale=127.5, chunk_blocks=chunk, async_depth=depth,
        active_slots=slots, fetch_open_flags=flags, fetch_audio_i16=i16,
        fetch_audio_fmt=fmt, suppress_fade_tails=suppress, fetch_meta_per_chunk=meta_per_chunk, device="cpu",
    )


@functools.cache
def _scene(name):
    return {"am": scene_u8, "am1.2": lambda: scene_u8(secs=1.2), "am1.0": lambda: scene_u8(secs=1.0), "nfm": nfm_scene_u8}[name]()


@functools.cache
def _cached_run(scene, specs, chunk, depth, **kw):
    p = Pipeline(_config(chunk, depth, **kw), _specs([dict(s) for s in specs]))
    return p, feed_all(p, _scene(scene))


def _run(scene, chunk, depth, specs=SCENE_SPECS, **kw):
    """One run, shared between the tests that read the same run (every test
    only reads the outputs)."""
    return _cached_run(scene, tuple(tuple(sorted(s.items())) for s in specs), chunk, depth, **kw)


def test_chain_matches_single_block_dispatch():
    p1, outs1 = _run("am", chunk=1, depth=0)
    p4, outs4 = _run("am", chunk=4, depth=1)
    assert len(outs1) == len(outs4) >= 10
    for o1, o4 in zip(outs1, outs4):
        assert o1.keys() == o4.keys()
        for k in o1:
            np.testing.assert_array_equal(o1[k], o4[k], err_msg=k)
    assert int(p1.state.open_count[0]) >= 1  # the scene opens and closes squelch
    for a, b in zip(p1.state, p4.state):
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            assert torch.equal(x, y)


def test_raw_ship_matches_pairs_ship():
    """Shipping raw u8 bytes (decoded on the device) against decoding on the
    host and shipping f32 pairs."""
    raw = _scene("am1.0")
    _, outs_raw = _run("am1.0", chunk=2, depth=1)
    z = decode_iq(raw, SampleFormat.U8)
    zc = (z[:, 0] + 1j * z[:, 1]).astype(np.complex64)
    cfg = PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="f32c", chunk_blocks=2,
                         async_depth=1, fetch_open_flags=True, device="cpu")
    p = Pipeline(cfg, _specs())
    assert p._resolve_ship(zc) == "pairs"
    outs_pairs = list(p.feed(zc)) + list(p.flush())
    assert len(outs_raw) == len(outs_pairs) >= 5
    # the decode itself is bit-equal (test above); the channelizer's GEMM
    # may order its sums otherwise for an input it did not decode itself,
    # so float-association noise is allowed, as in the JAX package's test
    for a, b in zip(outs_raw, outs_pairs):
        np.testing.assert_allclose(a["audio"], b["audio"], atol=1e-5)
        assert (a["open_flags"] == b["open_flags"]).mean() >= 0.999


def test_active_gather_matches_dense_on_open_channels():
    """With enough slots the reconstructed audio is bit-identical to the
    dense fetch for every channel, fade and 0.5 startup tails included;
    'active' and meta are unchanged."""
    _, dense = _run("am", chunk=4, depth=1)
    p, sparse = _run("am", chunk=4, depth=1, slots=3)
    assert len(dense) == len(sparse) >= 10
    opened_any = False
    for d, s in zip(dense, sparse):
        np.testing.assert_array_equal(d["active"], s["active"])
        opened_any |= bool(s["active"].any())
        np.testing.assert_array_equal(d["audio"], s["audio"])
        for k in ("signal_level", "noise_level", "squelch_level", "open_count"):
            np.testing.assert_array_equal(d[k], s[k])
        assert s["gather_overflow"] == 0
    assert opened_any
    assert p.gather_overflow_count == 0


def test_active_gather_overflow_counted():
    """More channels with audio than slots: squelch-open channels outrank
    fade-tail-only ones, ties keep the lowest channel index; dropped
    channels are silent for the block and the overflow is counted."""
    _, dense = _run("am", chunk=2, depth=0)
    p, sparse = _run("am", chunk=2, depth=0, slots=1)
    saw_overflow = False
    for d, s in zip(dense, sparse):
        active = s["active"]
        has_audio = active | d["audio"].any(axis=0)
        n_has = int(has_audio.sum())
        assert s["gather_overflow"] == max(0, n_has - 1)
        saw_overflow |= n_has > 1
        open_idx = np.flatnonzero(active)
        kept = open_idx[0] if len(open_idx) else (np.flatnonzero(has_audio)[0] if n_has else None)
        if kept is not None:
            np.testing.assert_array_equal(d["audio"][:, kept], s["audio"][:, kept])
            for ci in np.flatnonzero(has_audio):
                if ci != kept:
                    assert not s["audio"][:, ci].any()
    assert saw_overflow
    assert p.gather_overflow_count > 0


def test_flush_after_chunked_stream_needs_no_build(monkeypatch):
    """The JAX package compiles the k=1 flush program in the background; the
    port's k=1 chain runs the kernels the chunked chain already loaded, so
    the flush after a chunked stream builds nothing and starts no thread,
    and the streamed results equal an all-single-block run."""
    raw = _scene("am1.2")
    p = Pipeline(_config(4, 0), _specs())
    outs = []
    for i in range(0, len(raw), 512_000):
        outs.extend(p.feed(raw[i : i + 512_000]))
    assert p._pending_samples() >= p._block_len  # the flush has whole blocks left
    built = []
    monkeypatch.setattr(_build, "_build", lambda *a, **k: built.append(a))
    flushed = list(p.flush())
    assert flushed and not built and not p._warm_threads
    _, outs1 = _run("am1.2", chunk=1, depth=0)
    assert len(outs1) == len(outs + flushed)
    for a, b in zip(outs1, outs + flushed):
        np.testing.assert_array_equal(a["audio"], b["audio"])


def test_i16_audio_fetch_within_quantization_bound():
    """int16 audio (half the device-to-host bytes): every sample within one
    1/32767 step of the f32 fetch; gating, active flags and meta equal."""
    _, dense = _run("am", chunk=4, depth=1)
    _, q = _run("am", chunk=4, depth=1, i16=True)
    assert len(dense) == len(q) >= 10
    for d, s in zip(dense, q):
        np.testing.assert_array_equal(d["active"], s["active"])
        np.testing.assert_array_equal(d["open_flags"], s["open_flags"])
        assert np.abs(d["audio"] - s["audio"]).max() <= 1.0 / 32767.0 + 1e-7
        for k in ("signal_level", "noise_level", "open_count"):
            np.testing.assert_array_equal(d[k], s[k])


def test_i16_audio_fetch_composes_with_active_slots():
    _, dense = _run("am", chunk=2, depth=0)
    _, q = _run("am", chunk=2, depth=0, slots=3, i16=True)
    for d, s in zip(dense, q):
        np.testing.assert_array_equal(d["active"], s["active"])
        assert np.abs(d["audio"] - s["audio"]).max() <= 1.0 / 32767.0 + 1e-7


def test_i8bf_audio_fetch_within_quantization_bound():
    """Block-float int8 audio (a quarter of the bytes): every sample within
    half a step of its column's per-block scale; exact zeros stay exact;
    gating and meta equal."""
    _, dense = _run("am", chunk=4, depth=1)
    _, q = _run("am", chunk=4, depth=1, fmt="i8bf")
    assert len(dense) == len(q) >= 10
    for d, s in zip(dense, q):
        np.testing.assert_array_equal(d["active"], s["active"])
        np.testing.assert_array_equal(d["open_flags"], s["open_flags"])
        da, sa = d["audio"], s["audio"]
        step = np.abs(da).max(axis=0) / 127.0
        assert (np.abs(da - sa) <= step[None, :] * 0.5 + 1e-7).all()
        assert not sa[da == 0.0].any()
        for k in ("signal_level", "noise_level", "open_count"):
            np.testing.assert_array_equal(d[k], s[k])


def test_i8bf_composes_with_active_slots():
    _, dense = _run("am", chunk=2, depth=0)
    _, q = _run("am", chunk=2, depth=0, slots=3, fmt="i8bf")
    for d, s in zip(dense, q):
        np.testing.assert_array_equal(d["active"], s["active"])
        da, sa = d["audio"], s["audio"]
        step = np.abs(da).max(axis=0) / 127.0
        assert (np.abs(da - sa) <= step[None, :] * 0.5 + 1e-7).all()


def test_fade_tail_suppression_matches_dense():
    """Closed-channel tails synthesized on the host instead of shipped: NFM
    audio bit-exact (real-audio spill blocks ship by the must-ship rule),
    AM audio within f32 rounding of the 0.94^i fade restart; active and
    meta unchanged; the block-0 startup flood takes no slots."""
    _, dense = _run("nfm", chunk=4, depth=1, specs=NFM_SCENE_SPECS)
    p, s = _run("nfm", chunk=4, depth=1, specs=NFM_SCENE_SPECS, slots=2, suppress=True)
    assert len(dense) == len(s) >= 14
    nfm_closes = 0
    for i, (d, sb) in enumerate(zip(dense, s)):
        np.testing.assert_array_equal(d["active"], sb["active"])
        np.testing.assert_array_equal(d["audio"][:, 1], sb["audio"][:, 1], err_msg=f"block {i} NFM")
        np.testing.assert_allclose(d["audio"][:, 0], sb["audio"][:, 0], atol=2e-5, err_msg=f"block {i} AM")
        assert sb["gather_overflow"] == 0
        for k in ("signal_level", "noise_level", "open_count"):
            np.testing.assert_array_equal(d[k], sb[k])
        nfm_closes = max(nfm_closes, int(d["open_count"][1]))
    assert p.gather_overflow_count == 0
    assert nfm_closes >= 3
    assert dense[0]["audio"][:100].any()


def test_suppression_overflow_counts_only_must_ship():
    """With suppression on, fade-tail-only channels do not count for
    overflow: a 1-slot run counts only open (or NFM-spill) channels beyond
    the slot."""
    _, dense = _run("am", chunk=2, depth=0)
    _, s = _run("am", chunk=2, depth=0, slots=1, suppress=True)
    assert len(dense) == len(s)
    for sb in s:
        assert sb["gather_overflow"] == max(0, int(sb["active"].sum()) - 1)


def test_meta_per_chunk_matches_chunk_end_meta():
    """One stats snapshot per chunk: audio and active untouched, every block
    of a chunk reports the meta of the chunk's last block."""
    _, dense = _run("am", chunk=4, depth=1)
    _, outs = _run("am", chunk=4, depth=1, flags=False, meta_per_chunk=True)
    assert len(outs) == len(dense) >= 10
    for i, (d, s) in enumerate(zip(dense, outs)):
        np.testing.assert_array_equal(d["audio"], s["audio"], err_msg=f"block {i}")
        np.testing.assert_array_equal(d["active"], s["active"])
        j = min((i // 4) * 4 + 3, len(dense) - 1)
        for k in ("signal_level", "noise_level", "squelch_level", "open_count", "flappy_count"):
            np.testing.assert_array_equal(dense[j][k], s[k], err_msg=f"block {i} {k}")


def test_warm_does_not_change_results():
    """Pipeline.warm() runs the chain on zeroed inputs before streaming; it
    leaves the pipeline as it found it."""
    _, base = _run("am1.0", chunk=2, depth=1)
    p = Pipeline(_config(2, 1), _specs())
    p.warm()
    assert p.state is None and p.blocks_processed == 0 and p._ship is None
    outs = feed_all(p, _scene("am1.0"))
    assert len(outs) == len(base)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a["audio"], b["audio"])
        np.testing.assert_array_equal(a["active"], b["active"])


class ColumnScatter:
    """The plain reference of the active-gather unpack: the row-major
    column scatter ``Pipeline._to_host`` ran before its channel-major one.
    A chunk's audio is restored whole, each block's valid slot columns are
    scattered into a reused [W, C] buffer, and the fade tails are written
    as columns."""

    def __init__(self, C, W, A, suppress):
        self.A, self.suppress = A, suppress
        self.audio = np.zeros((W, C), np.float32)
        self.iq = np.zeros((W, C, 2), np.float32)
        self.dirty = self.iq_dirty = np.zeros(0, np.int64)
        self.pending = np.zeros(C, np.float32)
        self.startup = True
        self.pow94 = np.power(np.float32(0.94), np.arange(1, A, dtype=np.float32))

    def chunk(self, host):
        host = dict(host)
        if host["audio"].dtype == np.int16:
            host["audio"] = host["audio"].astype(np.float32) * (1.0 / 32767.0)
        elif host["audio"].dtype == np.int8:
            host["audio"] = host["audio"].astype(np.float32) * host["audio_scale"][:, None, :]
        for i in range(len(host["slot_channel"])):
            idx = host["slot_channel"][i]
            valid = idx >= 0
            cols = idx[valid]
            self.audio[:, self.dirty] = 0.0
            self.audio[:, cols] = host["audio"][i][:, valid]
            self.dirty = cols
            if self.suppress:
                self.fade(cols)
            self.iq[:, self.iq_dirty] = 0.0
            self.iq[:, cols] = host["iq_out"][i][:, valid]
            self.iq_dirty = cols
            yield dict(audio=self.audio, iq_out=self.iq,
                       gather_overflow=max(0, int(host["n_active"][i]) - int(valid.sum())))

    def fade(self, cols):
        A, audio = self.A, self.audio
        if self.startup:
            mask = np.ones(audio.shape[1], bool)
            mask[cols] = False
            synth = np.flatnonzero(mask)
            audio[:A, synth] = np.float32(0.5)
            self.startup = False
        else:
            synth = np.flatnonzero(self.pending)
            if len(synth):
                synth = synth[~np.isin(synth, cols, assume_unique=False)]
            if len(synth):
                audio[: A - 1, synth] = self.pending[synth][None, :] * self.pow94[:, None]
        self.pending[:] = 0.0
        if len(cols):
            self.pending[cols] = audio[-1, cols]
        if len(synth):
            self.dirty = np.concatenate([cols, synth])


def _fetched_chunk(rng, C, W, K, S, fmt):
    """One chunk as the active-gather fetch holds it: each block wants a
    random set of channels, the first S of them (in a random order) hold
    the valid slot prefix, and the empty slots are zeros with scale 0."""
    audio = np.zeros((K, W, S), {"i8bf": np.int8, "i16": np.int16, "f32": np.float32}[fmt])
    scale = np.zeros((K, S), np.float32)
    iq = np.zeros((K, W, S, 2), np.float32)
    slot_channel = np.full((K, S), -1, np.int32)
    active = np.zeros((K, C), bool)
    n_active = np.zeros(K, np.int32)
    for i in range(K):
        wanted = rng.permutation(rng.choice(C, size=int(rng.integers(1, C // 3)), replace=False))
        active[i, wanted] = True
        n_active[i] = len(wanted)
        n = min(S, len(wanted))
        slot_channel[i, :n] = wanted[:n]
        if fmt == "f32":
            audio[i, :, :n] = rng.normal(0.0, 0.3, (W, n))
        else:
            top = 127 if fmt == "i8bf" else 32767
            audio[i, :, :n] = rng.integers(-top, top + 1, (W, n))
            scale[i, :n] = rng.uniform(1e-3, 1.0 / 127.0, n)
        iq[i, :, :n] = rng.normal(0.0, 0.3, (W, n, 2))
    host = dict(audio=audio, slot_channel=slot_channel, n_active=n_active, active=active, iq_out=iq,
                meta_f=np.zeros((K, 3, C), np.float32), meta_i=np.zeros((K, 5, C), np.int32))
    if fmt == "i8bf":
        host["audio_scale"] = scale
    return host


@pytest.mark.parametrize("slots", ["plentiful", "scarce"])
@pytest.mark.parametrize("suppress", [True, False], ids=["suppress", "ship_tails"])
@pytest.mark.parametrize("fmt", ["i8bf", "i16", "f32"])
def test_channel_major_unpack_matches_column_scatter(fmt, suppress, slots):
    """The channel-major unpack yields, bit for bit, what the row-major
    column scatter yields: every block's audio and iq, its overflow and the
    fade tails carried to the next block, over a stream whose open set
    changes every block and whose slot count changes between chunks (a
    fetch-economy rung).  With scarce slots, open channels the slots drop
    get the fade synthesis (ROADMAP H4)."""
    C, K = 48, 3
    specs = [ChannelSpec(frequency=CENTER - 600_000 + 25_000 * j, modulation="am") for j in range(C)]
    p = Pipeline(_config(K, 0, slots=4, fmt=fmt, suppress=suppress), specs)
    ref = ColumnScatter(C, p.W, p.A, suppress)
    rng = np.random.default_rng(16)
    blocks = synth_on_dropped = 0
    for c, S in enumerate((20, 20, 24) if slots == "plentiful" else (4, 4, 6)):
        host = _fetched_chunk(rng, C, p.W, K, S, fmt)
        item = (K, c * K, ({k: torch.from_numpy(v) for k, v in host.items()}, None, None))
        for i, (got, want) in enumerate(zip(p._to_host(item), ref.chunk(host), strict=True)):
            assert got["audio"].shape == (p.W, C) and got["iq_out"].shape == (p.W, C, 2)
            for key in ("audio", "iq_out"):
                np.testing.assert_array_equal(np.ascontiguousarray(got[key]).view(np.uint32),
                                              want[key].view(np.uint32), err_msg=f"block {blocks} {key}")
            assert got["gather_overflow"] == want["gather_overflow"]
            np.testing.assert_array_equal(p._tail_pending.view(np.uint32), ref.pending.view(np.uint32))
            dropped = np.setdiff1d(np.flatnonzero(host["active"][i]), host["slot_channel"][i])
            synth_on_dropped += blocks > 0 and bool(want["audio"][:, dropped].any())
            blocks += 1
    assert blocks >= 6
    if slots == "plentiful":
        assert p.gather_overflow_count == 0
    else:
        assert p.gather_overflow_count > 0
        assert (synth_on_dropped > 0) == suppress
