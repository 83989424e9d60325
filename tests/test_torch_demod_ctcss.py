"""The demod's CTCSS pass, run on the host after K1.

K1 leaves a CTCSS channel's Goertzel banks, its tone gate and what the gate
feeds (notch, ampfactor and clamp, open flag, gated IQ) to the CTCSS pass
(csrc/demod_ctcss.cuh): K1 writes waveout and the squelch's bits, the pass
finishes them a tile of 32 samples at a time, skipping tiles where nothing
is open, steps or resets.  ``demod_block_host`` runs both as the card does,
built with g++; over three consecutive blocks it must equal the plain
``demod_block`` bit for bit in every output and state leaf.  The air
carries a 100 Hz CTCSS tone and a 1 kHz voice tone, so windows decide,
the gate opens and the notch runs behind it.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import CLOSED, OPEN, demod_block
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
from torch_port_common import CENTER, FS, N, assert_bitwise

WAVE_RATE = 16000  # fast window 800 samples, slow 6400
TONE_HZ = 100.0
BANK_LEAVES = [f"{b}.{k}" for b in ("fast", "slow") for k in ("q1", "q2", "count", "enough", "has_tone", "found", "not_found")]


class Case(NamedTuple):
    kinds: tuple  # a ChannelSpec keyword set a channel, cycled over C
    C: int
    W: int
    open_ct: bool  # CTCSS channels start OPEN (else CLOSED, and open on the air)
    fast_left: int | None  # samples left in the fast window at the start (None: a fresh window)
    slow_left: int | None
    close_at: int | None  # the air drops to noise from this sample of the stream on
    with_iq: bool = True
    with_ctcss: bool = True


AM = dict(modulation="am")
AM_CT = dict(modulation="am", ctcss=TONE_HZ)
NFM = dict(modulation="nfm", bandwidth=8000)
NFM_CT = dict(modulation="nfm", ctcss=TONE_HZ)
NOTCH_CT = dict(modulation="nfm", ctcss=TONE_HZ, notch=1000.0)
IQ_CT = dict(modulation="nfm", ctcss=TONE_HZ, has_iq_outputs=True)
AM_NOTCH_IQ = dict(modulation="am", bandwidth=6000, notch=1000.0, has_iq_outputs=True)

CASES = {
    # am8192's population: one AM CTCSS channel among 127 AM channels
    "one_am_ctcss_in_128": Case((AM_CT,) + (AM,) * 127, 128, 200, True, 40, 100, None, with_iq=False),
    # a run of 32 NFM CTCSS channels (one warp's worth) that open on the air,
    # then close mid-block when it drops: the banks reset
    "nfm_run_opens_then_closes": Case((AM, NFM) * 3 + (NFM_CT,) * 32 + (AM, NFM), 40, 400, False, 150, None, 600),
    # the fast window ends in block 1 (it straddles the boundary), the slow
    # one mid-block 2, after which the fast bank stops; a partial last tile
    "windows_straddle_blocks": Case((NFM_CT, AM, AM_CT, NFM), 64, 131, True, 131 + 20, 2 * 131 + 50, None),
    # a fresh fast window decides inside block 0, so the gate opens on the
    # tone and the notch of a notch + CTCSS channel runs behind it; IQ
    # outputs gated on and off
    "notch_and_iq_with_iq": Case((NOTCH_CT, IQ_CT, AM_NOTCH_IQ, AM_CT), 8, 900, True, None, None, None, with_iq=True),
    "notch_and_iq_without_iq": Case((NOTCH_CT, IQ_CT, AM_NOTCH_IQ, AM_CT), 8, 900, True, None, None, None, with_iq=False),
    # W = 100: the block is the iq_tail rows alone, four tiles, the last of 4
    "w100": Case((NFM_CT, AM, NOTCH_CT, IQ_CT), 65, 100, True, 30, 90, None),
    # the banks off for the block: K1 carries every bank leaf through
    "with_ctcss_off": Case((NFM_CT, AM, AM_CT, NFM), 65, 131, True, 40, 100, None, with_ctcss=False),
}


def _params(case: Case):
    specs = [ChannelSpec(**case.kinds[i % len(case.kinds)], frequency=119_500_000 + 8_000 * i) for i in range(case.C)]
    return make_channel_params(specs, wave_rate=WAVE_RATE, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")


def _state(params, case: Case, rng):
    """A low noise floor and high signal averages; the CTCSS channels OPEN
    (or CLOSED) with their windows ``fast_left`` / ``slow_left`` samples
    from their end."""
    C = case.C
    st = init_demod_state(
        C,
        torch.from_numpy(np.abs(rng.normal(0, 1.0, (100, C))).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.5, (100, C, 2)).astype(np.float32)),
    )
    d = interop.state_to_numpy(st)
    ct = params.ctcss_enabled.numpy()
    d["noise_floor"] = np.full(C, 0.3, np.float32)
    d["pre_full"] = d["pre_capped"] = np.full(C, 1.2, np.float32)
    d["cur"] = d["nxt"] = np.where(ct, OPEN if case.open_ct else CLOSED, d["cur"]).astype(np.int32)
    for bank, left in (("fast", case.fast_left), ("slow", case.slow_left)):
        if left is not None:
            d[f"{bank}.count"] = np.where(ct, getattr(params, f"{bank}_window").numpy() - left, 0).astype(np.int32)
    return interop.state_from_numpy(d, device="cpu")


def _air(params, case: Case, blk: int, rng):
    """Block ``blk`` of the channelizer's output: AM channels an envelope,
    NFM channels a phase, both carrying the CTCSS tone and a voice tone,
    over noise; after ``close_at`` noise alone."""
    W, C = case.W, case.C
    n = blk * W + np.arange(W)
    t = n / WAVE_RATE
    tone, voice = np.cos(2 * np.pi * TONE_HZ * t), np.sin(2 * np.pi * 1000.0 * t)
    level = np.where(n < case.close_at, 3.0, 0.0) if case.close_at is not None else np.full(W, 3.0)
    phase = 2 * np.pi * np.cumsum(300.0 * tone + 2500.0 * voice) / WAVE_RATE
    theta = rng.uniform(0, 2 * np.pi, C)
    am = (level * (1 + 0.3 * tone + 0.4 * voice))[:, None] * np.exp(1j * theta)[None, :]
    fm = level[:, None] * np.exp(1j * (phase[:, None] + theta[None, :]))
    z = np.where(params.is_nfm.numpy()[None, :], fm, am)
    z = z + 0.02 * (rng.normal(size=(W, C)) + 1j * rng.normal(size=(W, C)))
    mags = torch.from_numpy(np.abs(z).astype(np.float32))
    iqs = torch.from_numpy(np.stack([z.real, z.imag], axis=-1).astype(np.float32))
    return mags, iqs


@pytest.mark.parametrize("name", list(CASES))
def test_k1_and_pass_match_plain(name):
    """K1 + the CTCSS pass (host build) against the plain version, three
    blocks threading the state, bit for bit; then what the scene was built
    to reach, so a case cannot pass without exercising its path."""
    case = CASES[name]
    params = _params(case)
    rng = np.random.default_rng(case.C * 1000 + case.W)
    ps = hs = state0 = _state(params, case, rng)
    ct = params.ctcss_enabled
    opened = torch.zeros(case.C, dtype=torch.bool)
    for blk in range(3):
        m, q = _air(params, case, blk, rng)
        pout = demod_block(params, ps, m, q, with_ctcss=case.with_ctcss)
        hout = demod_cuda.demod_block_host(params, hs, m, q, with_ctcss=case.with_ctcss, with_iq=case.with_iq)
        if not case.with_iq:
            pout = (pout[0], pout[1], torch.zeros_like(pout[2]), pout[3])
        assert_bitwise(pout, hout, f"{name} block {blk}")
        opened |= hout[3].any(dim=0)
        ps, hs = pout[0], hout[0]

    d0, d = interop.state_to_numpy(state0), interop.state_to_numpy(hs)
    decided = (hs.fast.found + hs.fast.not_found + hs.slow.found + hs.slow.not_found)[ct]
    if not case.with_ctcss:
        for k in BANK_LEAVES:
            assert np.array_equal(d0[k], d[k]), f"{name}: bank leaf {k} moved with the banks off"
        assert bool(opened[ct].any())
        return
    assert int(decided.min()) > 0, f"{name}: a CTCSS window never decided"
    nct = ~ct  # the other channels' banks never step
    for k in BANK_LEAVES:
        assert np.array_equal(d0[k][..., nct.numpy()], d[k][..., nct.numpy()]), f"{name}: {k} of a channel without CTCSS moved"
    if name == "nfm_run_opens_then_closes":
        assert bool((hs.open_count[ct] > 0).all()) and bool((hs.cur[ct] == CLOSED).all())
        assert not bool(hs.slow.enough[ct].any()) and int(hs.fast.count[ct].max()) == 0  # reset on the close
    if name == "windows_straddle_blocks":
        assert bool(hs.slow.enough[ct].all())
        assert bool((hs.fast.count[ct] < params.fast_window[ct]).all())
    if name.startswith("notch_and_iq"):
        assert int(hs.fast.found[ct].sum()) > 0, "the tone was never found"
        notch_ct = (params.notch_enabled & ct).numpy()
        assert not np.array_equal(d0["notch_x"][:, notch_ct], d["notch_x"][:, notch_ct]), "the gated notch never ran"
        assert bool(opened[ct].any())
