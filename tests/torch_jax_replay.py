"""The JAX package's Pipeline and the port's on one channelizer output, and
the bars their yielded blocks are held to (tests/test_torch_pipeline_parity.py,
tests/test_torch_checkpoint.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rtlsdr_airband_tpu.runtime.pipeline as jax_pipeline
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu import native
from rtlsdr_airband_tpu.ops import channelizer as jch
from rtlsdr_airband_tpu.ops.demod import CtcssState, DemodState
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from torch_port_common import ATOL


class RecordedChannelizer:
    """Records the JAX Pipeline's channelizer calls in order; the port's
    channelizer replays them.

    The carriers reach magnitudes ~100, where the squelch's signal average
    follows the channelizer's rounding, and XLA's and PyTorch's CPU GEMMs
    round differently: fed the same raw blocks, the two frameworks' levels
    went past 1e-4 in some fresh processes (tests/test_torch_pipeline.py::
    SharedChannelizer).  So the JAX run goes first, in :meth:`jax_run`,
    under ``jax.disable_jit()``: its chain's ``lax.scan`` then runs eagerly
    and the channelizer sees concrete arrays, while ``demod_block`` stays
    jitted (eagerly its W-step scan takes minutes).  The port's run then
    gets each recorded output after its own channelizer input and bins were
    found equal, bit for bit, to the ones JAX recorded (AFC and scan mode
    move the bins between calls).  The port's channelizers
    are held against float64 on their own (tests/test_torch_channelizer.py).
    The port's demod is K1's host build (``demod_cuda.demod_block_host``),
    equal to the plain version bit for bit (tests/test_torch_demod_tiled.py).
    The JAX Pipeline decodes its priming samples with its numpy LUT, as the
    port does, not with the native converter (see
    tests/test_torch_pipeline_parity.py::test_u8_decode_follows_the_lut).
    """

    def __init__(self, monkeypatch):
        self.calls: list = []
        self.replayed = 0
        monkeypatch.setattr(native, "native_available", lambda: False)
        for name in ("channelize_matmul", "channelize_fft"):
            monkeypatch.setattr(jax_pipeline, name, self._recorder(getattr(jch, name)))
            monkeypatch.setattr(port_pipeline, name, self._replay)
        real_demod = jax_pipeline.demod_block

        def demod_jitted(*a, **kw):
            with jax.disable_jit(False):
                return real_demod(*a, **kw)

        monkeypatch.setattr(jax_pipeline, "demod_block", demod_jitted)
        monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)

    def _recorder(self, real):
        def record(x, bins, window, **kw):
            out = real(x, bins, window, **kw)
            self.calls.append((np.asarray(x), np.asarray(bins), np.asarray(out[0]), np.asarray(out[1])))
            return out

        return record

    def _replay(self, x, bins, window, **kw):
        want_x, want_bins, mags, iq = self.calls[self.replayed]
        np.testing.assert_array_equal(x.cpu().numpy(), want_x, err_msg=f"channelizer input, call {self.replayed}")
        np.testing.assert_array_equal(bins.cpu().numpy(), want_bins, err_msg=f"channelizer bins, call {self.replayed}")
        self.replayed += 1
        return torch.from_numpy(mags.copy()), torch.from_numpy(iq.copy())

    @staticmethod
    def jax_run(fn):
        with jax.disable_jit():
            return fn()

    def all_replayed(self) -> bool:
        return bool(self.calls) and self.replayed == len(self.calls)


def jax_state(flat: dict) -> DemodState:
    """A JAX DemodState from a flat numpy dict keyed as
    ``rtlsdr_airband_tpu_torch.interop`` keys it."""
    kw = {}
    for k in DemodState._fields:
        if k in ("fast", "slow"):
            kw[k] = CtcssState(**{s: jnp.asarray(flat[f"{k}.{s}"]) for s in CtcssState._fields})
        else:
            kw[k] = jnp.asarray(flat[k])
    return DemodState(**kw)


def assert_blocks_close(want: list, got: list, label: str, audio_step=None) -> None:
    """Yielded block dicts of the JAX Pipeline (``want``) against the port's:
    the same keys, shapes and dtypes; bool and int entries (open_flags,
    active, the counters, sig_outside, gather_overflow) exactly equal;
    floats within ATOL with NaN at the same places; ``spectrum_power``
    within 1e-4 of each block's peak (two FFT libraries).  ``audio_step``
    ('i16' or 'i8bf') allows one quantization step on the audio: the two
    sides' float audio differs within ATOL, which may move a mantissa across
    a rounding boundary."""
    assert len(want) == len(got) > 0, f"{label}: {len(want)} vs {len(got)} blocks"
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.keys() == b.keys(), f"{label} block {i}: keys {sorted(a)} vs {sorted(b)}"
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            where = f"{label} block {i} {k}"
            assert x.shape == y.shape and x.dtype == y.dtype, f"{where}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
            if x.dtype.kind in "biu":
                assert np.array_equal(x, y), f"{where}: {np.sum(x != y)} entries differ"
                continue
            assert np.array_equal(np.isnan(x), np.isnan(y)), f"{where}: NaN positions"
            d = np.nan_to_num(np.abs(x.astype(np.float64) - y))
            bar = np.float64(ATOL)
            if k == "spectrum_power":
                bar = ATOL * np.abs(x).max()
            elif k == "audio" and audio_step == "i16":
                bar = 1.0 / 32767.0 + ATOL
            elif k == "audio" and audio_step == "i8bf":
                bar = np.maximum(np.abs(x), np.abs(y)).max(axis=0) / 127.0 + ATOL
            assert (d <= bar).all(), f"{where}: maxdiff {d.max():.3e}"
