"""Golden tests of the port's demod against the scalar NumPy reference model
(``rtlsdr_airband_tpu.refmodel.channel_ref``): tests/test_demod_golden.py's
AM, NFM and CTCSS scenes (``build_scene``), across block boundaries,
through the port's plain demod and through K1's host build (the kernel's
own code, g++) in the default schedule and at unroll 4.  Both sides consume
the reference channelizer's output; the bars are the golden test's own
(``assert_match``): audio to 2e-5 with the squelch gating identical, IQ
taps to 5e-4, int squelch state exact, the noise floor to rtol 1e-5 and the
AGC to 1e-4."""

import functools

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.refmodel.channel_ref import ChannelizerRef, ChannelRef, ChannelRefConfig, DeviceRef, bin_for_freq
from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import demod_block
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
from test_demod_golden import CENTER, FS, N, assert_match, build_scene, c2p, p2c

SCENES = {
    "am_basic": (8000, (dict(frequency=120_400_000, modulation="am"), dict(frequency=120_700_000, modulation="am", ampfactor=1.2)), None),
    "am_lowpass_notch_manual_iqout": (8000, (
        dict(frequency=120_400_000, modulation="am", bandwidth=6000, notch=1000.0, has_iq_outputs=True),
        dict(frequency=120_700_000, modulation="am", squelch_threshold_dbfs=-40.0),
    ), None),
    "nfm": (16000, (dict(frequency=120_300_000, modulation="nfm", bandwidth=8000), dict(frequency=120_900_000, modulation="nfm")), None),
    "nfm_ctcss": (16000, (dict(frequency=120_300_000, modulation="nfm", ctcss=100.0),), None),
    "ctcss_wrong_tone_blocks": (16000, (dict(frequency=120_300_000, modulation="nfm", ctcss=151.4),), 100.0),
}
DEMODS = {
    "plain": demod_block,
    "k1_host_u4": functools.partial(demod_cuda.demod_block_host, unroll=4),
    "k1_host_64": demod_cuda.demod_block_host,
}


@functools.cache
def reference(scene: str):
    """The scene's reference channelizer output and the reference model's
    audio, IQ taps and channels (the golden test's run_both, its JAX half
    left out)."""
    wr, specs_kw, tx_ctcss = SCENES[scene]
    specs = [ChannelSpec(**kw) for kw in specs_kw]
    bins = np.array([bin_for_freq(s.frequency, CENTER, FS, N) for s in specs], np.int32)
    mags, iqs = ChannelizerRef(N, FS, wr, bins).push(build_scene(wr, specs, 1.0, tx_ctcss=tx_ctcss))
    refchs = [ChannelRef(ChannelRefConfig(**{k: v for k, v in kw.items() if k in ChannelRefConfig.__dataclass_fields__}),
                         wr, N, FS, CENTER) for kw in specs_kw]
    batches = DeviceRef(refchs, wr).push(mags, iqs)
    return mags, iqs, np.concatenate([b[0] for b in batches], axis=1), np.concatenate([b[1] for b in batches], axis=1), refchs


@pytest.mark.parametrize("demod", list(DEMODS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_demod_matches_refmodel(scene, demod):
    wr, specs_kw, tx_ctcss = SCENES[scene]
    mags, iqs, ref_audio, ref_iq, refchs = reference(scene)
    W, A = wr // 8, AGC_EXTRA
    n_blocks = (mags.shape[1] - A) // W
    assert n_blocks >= 3, "need multiple blocks to exercise state carry"
    params = make_channel_params([ChannelSpec(**kw) for kw in specs_kw], wave_rate=wr, sample_rate=FS, center_freq=CENTER,
                                 fft_size=N, device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    state = init_demod_state(len(specs_kw), t(mags[:, :A].T), t(c2p(iqs[:, :A].T)))
    audio, iq_out = [], []
    for k in range(n_blocks):
        lo = A + k * W
        state, a, q, _ = DEMODS[demod](params, state, t(mags[:, lo : lo + W].T), t(c2p(iqs[:, lo : lo + W].T)))
        audio.append(a.numpy().T)
        iq_out.append(p2c(q.numpy()).T)
    audio, iq_out = np.concatenate(audio, axis=1), np.concatenate(iq_out, axis=1)
    n = min(ref_audio.shape[1], audio.shape[1])
    assert_match(ref_audio[:, :n], audio[:, :n], ref_iq[:, :n], iq_out[:, :n], refchs, state)
    if tx_ctcss is not None:  # the carrier is strong but its tone is not the channel's: silence
        assert np.all(audio[:, A:] == 0.0)
