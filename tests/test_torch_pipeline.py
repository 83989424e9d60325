"""Port parity: the block program of ``rtlsdr_airband_tpu_torch`` (decode,
channelizer, demod, user-order restore, state snapshots) against the JAX
package's block program (``demod_backend="xla"``), block by block on the
16-channel active flagship scene, and the port's flagship builders against
the JAX ones."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu.runtime.pipeline as jax_pipeline
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu.models.flagship import build_flagship as jax_build_flagship
from rtlsdr_airband_tpu.models.flagship import build_flagship_stream as jax_build_flagship_stream
from rtlsdr_airband_tpu.ops.channelizer import channelize_fft as jax_channelize_fft
from rtlsdr_airband_tpu.ops.channelizer import channelize_matmul as jax_channelize_matmul
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.models.flagship import FlagshipBlock, build_flagship, build_flagship_stream
from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_fft, channelize_matmul
from rtlsdr_airband_tpu_torch.runtime.pipeline import pipeline_block
from torch_port_common import CHANNELIZER_SNR_DB, assert_channelizer_close, assert_close, dft_at_bins, jax_flat, snr_db

PORT_KW = ("hop", "fft_size", "n_frames", "fm_quadri", "with_ctcss", "with_iq")


def _port_params(jparams):
    return interop.params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()}, device="cpu")


class SharedChannelizer:
    """Feeds both block programs the JAX channelizer's output for the block.

    The carriers reach magnitudes ~100, where the squelch's signal average
    follows the channelizer's rounding: fed the same raw blocks, the port's
    signal level and the jitted JAX program's stayed well inside the 1e-4
    bar in most fresh processes and went beyond it in a few.  So the block programs
    after the channelizer are compared on one channelizer output, and the
    port's channelizer is held on its own against the float64 DFT by the
    channelizer's bar, >= 80 dB SNR (as in tests/test_torch_channelizer.py).
    The port's decoded input must equal JAX's bit for bit.  Call the JAX
    block program first for each block.  Both channelizers, the matched
    filter and the FFT, are shared so."""

    def __init__(self, monkeypatch):
        for name, jax_fn, port_fn in (
            ("channelize_matmul", jax_channelize_matmul, channelize_matmul),
            ("channelize_fft", jax_channelize_fft, channelize_fft),
        ):
            monkeypatch.setattr(jax_pipeline, name, functools.partial(self._jax, jax_fn))
            monkeypatch.setattr(port_pipeline, name, functools.partial(self._port, port_fn))
        self.calls = 0

    def _jax(self, fn, x, bins, window, **kw):
        self.x = np.asarray(x)
        self.out = fn(x, bins, window, **kw)
        return self.out

    def _port(self, fn, x, bins, window, **kw):
        np.testing.assert_array_equal(x.numpy(), self.x)
        m, iq = fn(x, bins, window, **kw)
        shape = {k: kw[k] for k in ("hop", "fft_size", "n_frames")}
        assert_channelizer_close(m, iq, dft_at_bins(self.x, bins.numpy(), window.numpy(), **shape), f"channelizer call {self.calls}")
        self.calls += 1
        jm, jiq = (np.asarray(a) for a in self.out)
        return torch.from_numpy(jm.copy()), torch.from_numpy(jiq.copy())


def jax_block(x, bins, window, params, state, **kw):
    """The JAX package's block program, run op by op so that the shared
    channelizer reaches it (the jitted ``pipeline_block`` would reuse a
    trace)."""
    return jax_pipeline._pipeline_block_impl(x, bins, window, params, state, demod_backend="xla", **kw)


def test_active_scene_matches_jax_block_by_block(monkeypatch):
    """Squelch opens and closes on the AM carriers and the CTCSS banks
    accumulate on the keyed NFM carrier: every output key and the state
    agree with the JAX program on every block."""
    chan = SharedChannelizer(monkeypatch)
    C = 16
    jkw, jbins, jwin, jparams, jstate, jx, hot = jax_build_flagship_stream(n_channels=C)
    kw = {k: jkw[k] for k in PORT_KW}
    params = _port_params(jparams)
    state = interop.state_from_numpy(jax_flat(jstate), device="cpu")
    bins, window = torch.from_numpy(np.array(jbins)), torch.from_numpy(np.array(jwin))
    opened = closed = 0
    for k, xb in enumerate(jx):
        jstate, jout = jax_block(xb, jbins, jwin, jparams, jstate, **jkw)
        state, out = pipeline_block(torch.from_numpy(np.array(xb)), bins, window, params, state, **kw)
        assert_close({kk: v for kk, v in jout.items()}, out, f"block {k}")
        assert_close(jax_flat(jstate), interop.state_to_numpy(state), f"block {k} state")
        flags = np.asarray(jout["open_flags"])
        opened += int(flags[:, hot].sum())
        closed += int((flags[:-1, hot] & ~flags[1:, hot]).sum())
    assert opened > 0 and closed > 0 and chan.calls == len(jx)
    assert int(np.asarray(jstate.slow.found).sum() + np.asarray(jstate.fast.found).sum()) > 0


def test_fft_channelizer_and_afc_match_jax_block(monkeypatch):
    """The block program with the FFT channelizer and the AFC spectrum
    (use_fft, with_afc) against JAX's, op by op, on the active scene: every
    output and the state within the bars, ``spectrum_power`` (|X|^2 of the
    block's last frame, each framework's own FFT) within 1e-4 of its peak
    and at >= 80 dB against float64."""
    chan = SharedChannelizer(monkeypatch)
    jkw, jbins, jwin, jparams, jstate, jx, hot = jax_build_flagship_stream(n_channels=16, n_blocks=4)
    kw = {k: jkw[k] for k in PORT_KW}
    params = _port_params(jparams)
    state = interop.state_from_numpy(jax_flat(jstate), device="cpu")
    bins, window = torch.from_numpy(np.array(jbins)), torch.from_numpy(np.array(jwin))
    for k, xb in enumerate(jx):
        jstate, jout = jax_block(xb, jbins, jwin, jparams, jstate, **dict(jkw, use_fft=True, with_afc=True))
        state, out = pipeline_block(torch.from_numpy(np.array(xb)), bins, window, params, state, use_fft=True, with_afc=True, **kw)
        want, got = np.asarray(jout.pop("spectrum_power")), out.pop("spectrum_power").numpy()
        assert_close(jout, out, f"block {k}")
        assert_close(jax_flat(jstate), interop.state_to_numpy(state), f"block {k} state")
        assert got.shape == want.shape == (kw["fft_size"],) and got.dtype == np.float32
        assert np.abs(got.astype(np.float64) - want).max() <= 1e-4 * want.max(), f"block {k} spectrum_power"
        start = (kw["n_frames"] - 1) * kw["hop"]
        frame = np.asarray(xb, np.float64)[start : start + kw["fft_size"]]
        ref = np.abs(np.fft.fft((frame[:, 0] + 1j * frame[:, 1]) * np.asarray(jwin, np.float64))) ** 2
        assert snr_db(got, ref) >= CHANNELIZER_SNR_DB
    assert chan.calls == len(jx)


def test_raw_u8_input_and_user_order_restore(monkeypatch):
    """The flagship block (channels regrouped by cost class, outputs
    restored to user order) fed raw u8 bytes, against JAX."""
    chan = SharedChannelizer(monkeypatch)
    C, W = 16, 128
    jkw, (jx, jbins, jwin, jparams, jstate) = jax_build_flagship(n_channels=C, wave_batch=W)
    assert jkw["inv_perm"] is not None
    raw = np.clip(np.round(np.asarray(jx).reshape(-1) * 127.5 + 127.5), 0, 255).astype(np.uint8)
    jst, jout = jax_block(jnp.asarray(raw), jbins, jwin, jparams, jstate, sample_fmt="u8", **jkw)
    block, x, state = build_flagship(n_channels=C, wave_batch=W, device="cpu")
    block.block_kwargs["sample_fmt"] = "u8"
    st, out = block(torch.from_numpy(raw), state)
    assert chan.calls == 1
    assert_close(jout, out, "u8 block")
    assert_close(jax_flat(jst), interop.state_to_numpy(st), "u8 block state")
    # both backends of the port agree; the plain one needs no card either
    kw = dict(block.block_kwargs, demod_backend="plain")
    st3, out3 = pipeline_block(torch.from_numpy(raw), block.bins, block.window, block.params, state,
                               taps=(block.taps_re, block.taps_im), inv_perm=block.inv_perm, **kw)
    for k in out:
        assert torch.equal(out[k], out3[k]), k


def test_flagship_builders_match_jax():
    C, W = 16, 128
    jkw, (jx, jbins, jwin, jparams, jstate) = jax_build_flagship(n_channels=C, wave_batch=W)
    block, x, state = build_flagship(n_channels=C, wave_batch=W, device="cpu")
    assert isinstance(block, FlagshipBlock)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert np.array_equal(block.bins.numpy(), np.asarray(jbins)) and np.array_equal(block.window.numpy(), np.asarray(jwin))
    assert np.array_equal(block.inv_perm.numpy(), np.asarray(jkw["inv_perm"]))
    assert_close({k: np.asarray(v) for k, v in _port_params(jparams)._asdict().items()}, block.params._asdict(), "params")
    assert_close(jax_flat(jstate), interop.state_to_numpy(state), "state")
    assert {k: block.block_kwargs[k] for k in PORT_KW} == {k: jkw[k] for k in PORT_KW}
    assert {"bins", "window", "taps_re", "taps_im", "inv_perm", "p_dm_dphi"} <= dict(block.named_buffers()).keys()

    jkw, jbins, jwin, jparams, jstate, jx, hot = jax_build_flagship_stream(n_channels=C, n_blocks=3)
    block, state, xs, hot2 = build_flagship_stream(n_channels=C, n_blocks=3, device="cpu")
    assert hot2 == hot and len(xs) == len(jx)
    for a, b in zip(jx, xs):
        assert np.array_equal(b.numpy(), np.asarray(a))
    # the priming state comes from each framework's channelizer
    assert_close(jax_flat(jstate), interop.state_to_numpy(state), "stream state")


def test_default_device_needs_a_card():
    """Entry points default to the card; without one they raise rather than
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        build_flagship(n_channels=8, wave_batch=128)
    with pytest.raises((AssertionError, RuntimeError)):
        build_flagship_stream(n_channels=8, n_blocks=1)


def test_unknown_backend_rejected():
    block, x, state = build_flagship(n_channels=8, wave_batch=128, device="cpu")
    with pytest.raises(ValueError, match="demod_backend"):
        pipeline_block(x, block.bins, block.window, block.params, state, demod_backend="xla", **{k: block.block_kwargs[k] for k in PORT_KW})
