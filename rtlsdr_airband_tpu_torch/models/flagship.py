"""Flagship model: a fully loaded multi-channel airband block program.

Counterpart of ``rtlsdr_airband_tpu/models/flagship.py``: a mixed AM/NFM
channel population with CTCSS, lowpass and notch - the maximal configuration
surface of the framework in one block step.  ``FlagshipBlock`` holds the
block's constant tensors as buffers and runs ``pipeline_block``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..constants import AGC_EXTRA
from ..ops.channelizer import channelize_matmul, make_taps
from ..ops.demod import ChannelParams, DemodState
from ..ops.params import ChannelSpec, cost_group_permutation, init_demod_state, make_channel_params
from ..ops.window import blackman_harris_7
from ..refmodel.channel_ref import bin_for_freq
from ..runtime.pipeline import pipeline_block
from ..utils.siggen import am_carrier_iq, complex_noise, nfm_carrier_iq

CENTER_FREQ = 120_000_000


class FlagshipBlock(nn.Module):
    """One block program: ``forward(x, state) -> (state', outputs)``.

    Buffers: ``bins``, ``window``, the matched-filter taps ``taps_re`` /
    ``taps_im``, every ChannelParams field as ``p_<field>`` and ``inv_perm``
    (None when channels run in user order)."""

    def __init__(self, bins, window, params: ChannelParams, inv_perm=None, **block_kwargs):
        super().__init__()
        self.register_buffer("bins", bins)
        self.register_buffer("window", window)
        taps_re, taps_im = make_taps(bins, window)
        self.register_buffer("taps_re", taps_re)
        self.register_buffer("taps_im", taps_im)
        for name in ChannelParams._fields:
            self.register_buffer(f"p_{name}", getattr(params, name))
        self.register_buffer("inv_perm", inv_perm)
        self.block_kwargs = block_kwargs

    @property
    def params(self) -> ChannelParams:
        return ChannelParams(*(getattr(self, f"p_{name}") for name in ChannelParams._fields))

    def forward(self, x: torch.Tensor, state: DemodState):
        return pipeline_block(
            x, self.bins, self.window, self.params, state,
            taps=(self.taps_re, self.taps_im), inv_perm=self.inv_perm, **self.block_kwargs,
        )


def flagship_specs(n_channels: int, center_freq: int = CENTER_FREQ, sample_rate: int = 2_560_000) -> list[ChannelSpec]:
    """Mixed channel population spread across the usable band."""
    specs = []
    span = int(sample_rate * 0.8)
    for i in range(n_channels):
        freq = center_freq - span // 2 + (i + 1) * span // (n_channels + 1)
        kind = i % 4
        if kind == 0:
            specs.append(ChannelSpec(frequency=freq, modulation="am"))
        elif kind == 1:
            specs.append(ChannelSpec(frequency=freq, modulation="am", bandwidth=6000, notch=1000.0))
        elif kind == 2:
            specs.append(ChannelSpec(frequency=freq, modulation="nfm", bandwidth=8000))
        else:
            specs.append(ChannelSpec(frequency=freq, modulation="nfm", ctcss=100.0))
    return specs


def _bins_window(specs, sample_rate, fft_size, device):
    bins = torch.as_tensor(np.array([bin_for_freq(s.frequency, CENTER_FREQ, sample_rate, fft_size) for s in specs], np.int32), device=device)
    return bins, torch.as_tensor(blackman_harris_7(fft_size), device=device)


def build_flagship(
    n_channels: int = 64,
    *,
    wave_batch: int | None = None,
    sample_rate: int = 2_560_000,
    fft_size: int = 512,
    wave_rate: int = 16000,
    seed: int = 0,
    device="cuda",
):
    """Returns (block, x, state): the FlagshipBlock, one [L, 2] input block
    and the initial state, the same values the JAX package's build_flagship
    makes from the same seed."""
    specs = flagship_specs(n_channels, CENTER_FREQ, sample_rate)
    # production layout: channels grouped by cost class, with the user-order
    # restore gather included for honest timing
    order = cost_group_permutation(specs)
    specs = [specs[i] for i in order]
    unperm = np.argsort(order).astype(np.int64)
    inv_perm = None if np.array_equal(order, np.arange(len(specs))) else torch.as_tensor(unperm, device=device)
    hop = int(round(sample_rate / wave_rate))
    W = wave_batch if wave_batch is not None else wave_rate // 8
    A, C = AGC_EXTRA, len(specs)

    params = make_channel_params(specs, wave_rate=wave_rate, sample_rate=sample_rate, center_freq=CENTER_FREQ, fft_size=fft_size, device=device)
    bins, window = _bins_window(specs, sample_rate, fft_size, device)

    # synthetic priming state + input block
    rng = np.random.default_rng(seed)
    prime_mags = torch.as_tensor(np.abs(rng.normal(0, 1.0, (A, C))).astype(np.float32), device=device)
    prime_iqs = torch.as_tensor(rng.normal(0, 0.5, (A, C, 2)).astype(np.float32), device=device)
    state = init_demod_state(C, prime_mags, prime_iqs)

    L = (W - 1) * hop + fft_size
    z = am_carrier_iq(sample_rate, 400_000, L, carrier_ampl=0.4) + complex_noise(L, 0.02, seed)
    x = torch.as_tensor(np.stack([z.real, z.imag], axis=-1).astype(np.float32), device=device)

    block = FlagshipBlock(bins, window, params, inv_perm, hop=hop, fft_size=fft_size, n_frames=W, fm_quadri=False, with_ctcss=True, with_iq=False)
    return block, x, state


def build_flagship_stream(
    n_channels: int = 16,
    *,
    n_blocks: int = 12,
    wave_batch: int = 128,
    sample_rate: int = 2_560_000,
    fft_size: int = 512,
    wave_rate: int = 16000,
    seed: int = 0,
    gate: tuple[float, float] = (0.0, 0.62),
    device="cuda",
):
    """Multi-block ACTIVE scene: strong carriers sit exactly ON three channels
    of different cost classes (plain AM, NFM+CTCSS, filtered AM+notch); the
    AM carriers switch on/off at ``gate`` fractions of the stream so the
    squelch both OPENS and CLOSES mid-stream; the NFM carrier stays keyed
    with a 100 Hz CTCSS tone so the Goertzel banks accumulate across blocks.

    The noise floor is pre-seeded to its converged quiet value (what ~0.25 s
    of closed-squelch noise would produce, squelch.cpp:196-246) so the scene
    needs tens, not thousands, of frames.

    Returns ``(block, state, x_blocks, hot)``: x_blocks is a list of
    ``n_blocks`` [L, 2] f32 inputs (phase-continuous slices of one stream)
    and ``hot`` the device-order indices of the three carrier channels.
    """
    user_specs = flagship_specs(n_channels, CENTER_FREQ, sample_rate)
    if n_channels < 4:
        raise ValueError("need all four cost classes (n_channels >= 4)")
    i_am = 0  # kind 0: plain AM
    i_ct = min(i for i in range(n_channels) if i % 4 == 3)  # NFM + CTCSS
    i_filt = max(i for i in range(n_channels) if i % 4 == 1)  # AM + bw/notch
    hot_user = [i_am, i_ct, i_filt]

    order = cost_group_permutation(user_specs)
    specs = [user_specs[i] for i in order]
    inv = np.argsort(order)
    hot = sorted(int(inv[i]) for i in hot_user)

    hop = int(round(sample_rate / wave_rate))
    W, A, C, N = wave_batch, AGC_EXTRA, n_channels, fft_size
    params = make_channel_params(specs, wave_rate=wave_rate, sample_rate=sample_rate, center_freq=CENTER_FREQ, fft_size=N, device=device)
    bins, window = _bins_window(specs, sample_rate, N, device)

    # one continuous stream: quiet priming prefix, then n_blocks of carriers
    prime_consumed = A * hop
    body = n_blocks * W * hop
    total = prime_consumed + (body - hop) + N
    z = complex_noise(total, 0.004, seed)

    secs = total / sample_rate
    t_a = np.arange(int(wave_rate * secs) + 2, dtype=np.float64) / wave_rate
    g0 = prime_consumed + int(body * gate[0])
    g1 = prime_consumed + int(body * gate[1])
    on = np.zeros(total, np.float32)
    on[g0:g1] = 1.0

    audio_am = (0.8 * np.sin(2 * np.pi * 800.0 * t_a)).astype(np.float32)
    z += on * am_carrier_iq(sample_rate, user_specs[i_am].frequency - CENTER_FREQ, total, audio=audio_am, carrier_ampl=0.45, audio_rate=wave_rate)
    audio_f = (0.8 * np.sin(2 * np.pi * 400.0 * t_a)).astype(np.float32)
    z += on * am_carrier_iq(sample_rate, user_specs[i_filt].frequency - CENTER_FREQ, total, audio=audio_f, carrier_ampl=0.45, audio_rate=wave_rate)
    # NFM keyed for the whole block region (CTCSS accumulates continuously)
    keyed = np.zeros(total, np.float32)
    keyed[prime_consumed:] = 1.0
    audio_n = (0.55 * np.sin(2 * np.pi * 600.0 * t_a) + 0.3 * np.sin(2 * np.pi * 100.0 * t_a)).astype(np.float32)
    z += keyed * nfm_carrier_iq(sample_rate, user_specs[i_ct].frequency - CENTER_FREQ, total, audio=audio_n, deviation_hz=2500.0, carrier_ampl=0.4, audio_rate=wave_rate)

    x_all = torch.as_tensor(np.stack([z.real, z.imag], axis=-1).astype(np.float32), device=device)

    # prime exactly like the streaming pipeline: channelize the first AGC_EXTRA frames
    prime_len = (A - 1) * hop + N
    mags, iqs = channelize_matmul(x_all[:prime_len], bins, window, hop=hop, fft_size=N, n_frames=A)
    state = init_demod_state(C, mags, iqs)
    # pre-seed the converged quiet floor (see docstring): numpy's median of
    # the AGC_EXTRA (even) rows, the float32 mean of the two middle values
    mid = torch.sort(mags, dim=0).values[A // 2 - 1 : A // 2 + 1]
    state = state._replace(noise_floor=(mid[0] + mid[1]) * 0.5 + 1e-4)

    blen = (W - 1) * hop + N
    x_blocks = [x_all[prime_consumed + k * W * hop : prime_consumed + k * W * hop + blen] for k in range(n_blocks)]
    block = FlagshipBlock(bins, window, params, None, hop=hop, fft_size=N, n_frames=W, fm_quadri=False, with_ctcss=True, with_iq=False)
    return block, state, x_blocks, hot

