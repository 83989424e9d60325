"""Checkpoint and resume of the port's Pipeline (port of
tests/test_checkpoint.py): a restarted pipeline gives bit-identical audio to
one that never stopped, and the npz is the JAX package's, so a JAX
checkpoint resumes in the port and a port checkpoint resumes in JAX, each
continuing like the other framework within the parity bars (the reference
has no DSP checkpointing — its recovery drops audio; SURVEY.md §5)."""

import numpy as np
import pytest

import rtlsdr_airband_tpu.runtime.pipeline as jax_pipeline
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise
from torch_jax_replay import RecordedChannelizer, assert_blocks_close
from torch_port_common import CENTER, FS, feed_all, scene_u8

SPECS = [dict(frequency=120_400_000, modulation="am"), dict(frequency=120_700_000, modulation="nfm", ctcss=100.0)]
# the production fetch economy, so the checkpoint carries a raw u8 stream,
# the fade-tail host state and the ship format
ECONOMY = dict(sample_format="u8", fullscale=127.5, chunk_blocks=2, async_depth=1, active_slots=2,
               fetch_audio_fmt="i8bf", suppress_fade_tails=True)


def port_pipe(**cfg):
    kw = dict(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="f32c", device="cpu")
    kw.update(cfg)
    return port_pipeline.Pipeline(port_pipeline.PipelineConfig(**kw), [ChannelSpec(**s) for s in SPECS])


def jax_pipe(**cfg):
    kw = dict(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="f32c")
    kw.update(cfg)
    return jax_pipeline.Pipeline(jax_pipeline.PipelineConfig(**kw), [JaxSpec(**s) for s in SPECS])


@pytest.fixture
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)


def test_checkpoint_resume_bit_identical(tmp_path, host_demod):
    n = int(FS * 1.2)
    z = (am_carrier_iq(FS, 400_000, n, carrier_ampl=0.35) + complex_noise(n, 0.02, 0)).astype(np.complex64)
    half = n // 2

    p1 = port_pipe()
    audio1 = [np.array(out["audio"]) for out in p1.feed(z)]

    p2 = port_pipe()
    audio2 = [np.array(out["audio"]) for out in p2.feed(z[:half])]
    ckpt = tmp_path / "dsp_state.npz"
    p2.save_state(str(ckpt))

    p3 = port_pipe()
    p3.load_state(str(ckpt))
    assert p3.blocks_processed == p2.blocks_processed
    audio2 += [np.array(out["audio"]) for out in p3.feed(z[half:])]

    a1, a2 = np.concatenate(audio1, axis=0), np.concatenate(audio2, axis=0)
    assert a1.shape == a2.shape
    np.testing.assert_array_equal(a1, a2)


def _halves(raw: bytes):
    cut = (len(raw) // 4) * 2  # whole IQ pairs
    return raw[:cut], raw[cut:]


def _first_half(p, raw):
    """Feed the first half, drain, and return the count of blocks yielded."""
    return len(feed_all(p, raw))


def _npz(path) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_checkpoint_keys_and_dtypes_match_jax(tmp_path, host_demod):
    """Same keys, dtypes and shapes as the JAX package's checkpoint of the
    same stream; the carried ints equal (dm_phi as uint32)."""
    first, _ = _halves(scene_u8(1.2))
    jp, tp = jax_pipe(**ECONOMY), port_pipe(**ECONOMY)
    assert _first_half(jp, first) == _first_half(tp, first) > 0
    jp.save_state(str(tmp_path / "jax.npz"))
    tp.save_state(str(tmp_path / "port.npz"))
    want, got = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port.npz")
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].shape == got[k].shape, k
    assert got["state.dm_phi"].dtype == np.uint32
    for k in ("pending", "ship", "tail_startup", "bins", "blocks_processed", "state.cur", "state.open_count"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_frameworks(monkeypatch, tmp_path, host_demod, direction):
    """One framework runs the first half and checkpoints; both frameworks
    load that file and continue on the second half, on one recorded
    channelizer output: the continuations agree within the parity bars.  A
    checkpoint saved right after loading the other framework's file gives
    that file back, key by key."""
    first, rest = _halves(scene_u8(1.2))
    ckpt = str(tmp_path / "first_half.npz")
    rec = RecordedChannelizer(monkeypatch)
    if direction == "jax_to_port":
        src = jax_pipe(**ECONOMY)
        rec.jax_run(lambda: _first_half(src, first))
        rec.calls.clear()
    else:
        monkeypatch.setattr(port_pipeline, "channelize_matmul", channelize_matmul)  # its own channelizer
        src = port_pipe(**ECONOMY)
        _first_half(src, first)
        monkeypatch.setattr(port_pipeline, "channelize_matmul", rec._replay)
    src.save_state(ckpt)

    jp, tp = jax_pipe(**ECONOMY), port_pipe(**ECONOMY)
    jp.load_state(ckpt)
    tp.load_state(ckpt)
    other = tp if direction == "jax_to_port" else jp  # the framework that did not write the file
    other_path = str(tmp_path / "reloaded.npz")
    other.save_state(other_path)
    saved, reloaded = _npz(ckpt), _npz(other_path)
    assert saved.keys() == reloaded.keys()
    for k in saved:
        assert saved[k].dtype == reloaded[k].dtype and saved[k].tobytes() == reloaded[k].tobytes(), k
    assert other.blocks_processed == src.blocks_processed > 0

    want = rec.jax_run(lambda: feed_all(jp, rest))
    got = feed_all(tp, rest)
    assert rec.all_replayed()
    assert_blocks_close(want, got, direction, audio_step="i8bf")
    assert jp.blocks_processed == tp.blocks_processed


def test_older_checkpoint_without_tail_state(tmp_path, host_demod):
    """A checkpoint from before fade-tail suppression (no tail_pending /
    tail_startup) loads as past startup with no fade pending, as the JAX
    package loads it."""
    first, _ = _halves(scene_u8(1.0))
    p = port_pipe(**ECONOMY)
    _first_half(p, first)
    p._tail_pending[:] = 0.25
    p.save_state(str(tmp_path / "new.npz"))
    d = _npz(tmp_path / "new.npz")
    del d["tail_pending"], d["tail_startup"]
    np.savez(tmp_path / "old.npz", **d)
    q = port_pipe(**ECONOMY)
    q.load_state(str(tmp_path / "old.npz"))
    assert not q._tail_startup and not q._tail_pending.any()
    assert q._primed and q._ship == "u8" and q.blocks_processed == p.blocks_processed
