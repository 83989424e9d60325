"""The demod's trace mode and the end-to-end SNR driver against the JAX
package, on the CPU.

- ``ops.demod.demod_block(..., trace=True)`` against the JAX
  ``demod_block(..., trace=True)`` (its XLA scan) on the same seeded inputs:
  the integer series (``cur``, ``nxt``, ``delay``) exact, the float ones
  (``nf``, ``pre_capped``, ``agc``, ``waveout``) within 1e-4; and tracing
  leaves the state, audio, IQ and flags bit for bit what ``trace=False``
  gives.  K1 has no trace mode: its wrapper raises when asked.
- ``scripts/e2e_snr.py --backend plain`` at 0.3 s of air: its audio equals
  the JAX script's chain (the XLA ``demod_block`` over the same refmodel
  channelizer outputs) within 1e-4, and its squelch gating is the
  refmodel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.ops.demod import demod_block as jax_demod_block
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import init_demod_state as jax_init_demod_state
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import CLOSED, demod_block
from rtlsdr_airband_tpu_torch.scripts import e2e_snr
from test_torch_demod import _assert_block_close, _assert_state_close, _block_inputs, _setup
from torch_port_common import ATOL, SPEC_KW, assert_bitwise

TRACE_KEYS = ("cur", "nxt", "nf", "pre_capped", "agc", "delay", "waveout")


@pytest.mark.parametrize("fm_quadri, with_ctcss", [(False, True), (True, False)])
def test_trace_matches_the_jax_trace(fm_quadri, with_ctcss):
    """Three blocks (strong, then weak: squelches open, close and fade; the
    CTCSS windows decide) traced in both packages, block by block."""
    W, wr = 200, 8000
    jp, js, tp, ts, rng = _setup(SPEC_KW, wr, seed=2, active=True)
    C = len(SPEC_KW)
    kw = dict(fm_quadri=fm_quadri, with_ctcss=with_ctcss)
    for blk in range(3):
        mags, iqs = _block_inputs(rng, W, C, strong=blk == 0)
        jout = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs), trace=True, **kw)
        m, q = torch.from_numpy(mags), torch.from_numpy(iqs)
        tout = demod_block(tp, ts, m, q, trace=True, **kw)
        assert_bitwise(demod_block(tp, ts, m, q, **kw), tout[:4], f"block {blk}: trace=True against trace=False")
        _assert_block_close(jout[:4], tout[:4], f"block {blk}")
        _assert_state_close(jout[0], tout[0], f"block {blk}")
        jtr, ttr = jout[4], tout[4]
        assert set(ttr) == set(jtr) == set(TRACE_KEYS)
        for k in TRACE_KEYS:
            a, b = np.asarray(jtr[k]), ttr[k].numpy()
            assert a.shape == b.shape == (W, C), k
            if k in ("cur", "nxt", "delay"):
                assert b.dtype == np.int32 and np.array_equal(a, b), f"block {blk}: {k}"
            else:
                assert b.dtype == np.float32 and np.abs(a.astype(np.float64) - b).max() <= ATOL, f"block {blk}: {k}"
        # the series are the state after each sample: the last row is the carried state
        assert torch.equal(ttr["cur"][-1], tout[0].cur) and torch.equal(ttr["nf"][-1], tout[0].noise_floor)
        js, ts = jout[0], tout[0]
    assert ((np.asarray(js.open_count) > 0) & (np.asarray(js.cur) == CLOSED)).sum() >= 2


def test_k1_has_no_trace_mode():
    """demod_block_cuda raises when asked to trace, on any device: no quiet
    switch to the plain version."""
    _jp, _js, tp, ts, rng = _setup(SPEC_KW, 8000, seed=3)
    mags, iqs = _block_inputs(rng, 120, len(SPEC_KW), strong=True)
    with pytest.raises(ValueError, match="no trace mode"):
        demod_cuda.demod_block_cuda(tp, ts, torch.from_numpy(mags), torch.from_numpy(iqs), trace=True)


def test_e2e_snr_plain_matches_the_jax_chain():
    """The script's plain run at 0.3 s (two blocks of 2000 samples, four
    channels, the CTCSS one among them) against the JAX script's chain on
    the same channelizer outputs, and against the refmodel."""
    result, audio = e2e_snr.run(0.3, "plain", torch.device("cpu"))
    mags, iqs, ref_audio = e2e_snr.scene(0.3)
    W, A = e2e_snr.WAVE_RATE // 8, 100
    specs = [JaxSpec(**kw) for kw in e2e_snr.SPECS_KW]
    params = jax_make_channel_params(specs, wave_rate=e2e_snr.WAVE_RATE, sample_rate=e2e_snr.FS,
                                     center_freq=e2e_snr.CENTER, fft_size=e2e_snr.N)

    def c2p(z):
        return np.stack([z.real, z.imag], -1).astype(np.float32)

    state = jax_init_demod_state(len(specs), mags[:, :A].T, c2p(iqs[:, :A].T))
    blocks = []
    for k in range((mags.shape[1] - A) // W):
        lo = A + k * W
        state, a, _iq, _o = jax_demod_block(params, state, jnp.asarray(mags[:, lo : lo + W].T), jnp.asarray(c2p(iqs[:, lo : lo + W].T)))
        blocks.append(np.asarray(a).T)
    jax_audio = np.concatenate(blocks, axis=1)
    assert audio.shape == jax_audio.shape == (4, 2 * W)
    assert np.abs(audio - jax_audio).max() <= ATOL
    assert result["squelch_gating_identical"] and result["samples_compared"] == 4 * 2 * W
    assert (audio != 0).mean() > 0.3  # the carriers opened their squelches
    m = audio.shape[1]
    assert np.array_equal(ref_audio[:, :m] != 0, audio != 0)
    worst = result["worst_snr_db"]
    assert worst == "inf" or worst >= 80.0
